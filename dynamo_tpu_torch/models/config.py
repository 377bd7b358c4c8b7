"""Model architecture configs (port of dynamo_tpu/models/config.py).

The field list is the reference's, so a config describes the same model
in both packages; this slice serves the dense GQA Llama trunk, and
``EngineConfig.validate`` rejects the features it does not serve yet
(MLA, MoE, sliding windows, qkv bias, QK-norm, the Gemma knobs).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    max_position: int = 8192
    tie_word_embeddings: bool = False
    qkv_bias: bool = False  # Qwen2-style
    qk_norm: bool = False   # Qwen3-style per-head RMSNorm on q/k
    # Sliding-window attention (0 = full causal attention).
    sliding_window: int = 0
    max_window_layers: int = 0
    # Gemma-3 family knobs.
    hidden_act: str = "silu"
    norm_offset: bool = False
    post_norms: bool = False
    embed_scale: bool = False
    window_pattern: int = 0
    rope_local_theta: float = 0.0
    query_pre_attn_scalar: float = 0.0
    # Mixtral-style sparse MoE.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Llama-3.1+ long-context rope scaling (ops/rope.py RopeScaling).
    rope_scaling: "object | None" = None
    # DeepSeek-V2/V3/R1 family (MLA).
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    first_k_dense_replace: int = 0
    gating: str = "softmax"
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    n_group: int = 1
    topk_group: int = 1
    moe_dispatch: str = "auto"
    moe_capacity_factor: float = 2.0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    def layer_window(self, layer_idx: int) -> int:
        """Sliding-window size for one layer (0 = full attention)."""
        if not self.sliding_window:
            return 0
        if self.window_pattern:
            if (layer_idx + 1) % self.window_pattern == 0:
                return 0
            return self.sliding_window
        if layer_idx >= self.max_window_layers:
            return self.sliding_window
        return 0

    def unsupported_features(self) -> list[str]:
        """Architecture features this slice of the port does not serve
        (each arrives with a later slice: ROADMAP queue A10)."""
        out = []
        if self.is_mla:
            out.append("MLA (kv_lora_rank)")
        if self.is_moe:
            out.append("MoE (num_experts)")
        if self.sliding_window:
            out.append("sliding-window attention")
        if self.qkv_bias:
            out.append("qkv bias")
        if self.qk_norm:
            out.append("QK-norm")
        if (
            self.hidden_act != "silu" or self.norm_offset or self.post_norms
            or self.embed_scale or self.rope_local_theta
            or self.query_pre_attn_scalar
        ):
            out.append("Gemma-family knobs")
        return out

    # -- presets ------------------------------------------------------------
    @staticmethod
    def tiny_test(vocab_size: int = 384) -> "ModelConfig":
        """Hermetic test model (pairs with the byte-level ToyTokenizer)."""
        return ModelConfig(
            name="tiny-test",
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            rope_theta=10000.0,
            max_position=512,
        )

    @staticmethod
    def llama32_1b() -> "ModelConfig":
        from dynamo_tpu_torch.ops.rope import RopeScaling

        return ModelConfig(
            name="llama3.2-1b",
            vocab_size=128256,
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=16,
            num_heads=32,
            num_kv_heads=8,
            head_dim=64,
            rope_theta=500000.0,
            max_position=131072,
            tie_word_embeddings=True,
            rope_scaling=RopeScaling(
                factor=32.0,
                low_freq_factor=1.0,
                high_freq_factor=4.0,
                original_max_position=8192,
            ),
        )

    def scaled(self, **kwargs) -> "ModelConfig":
        return replace(self, **kwargs)


PRESETS = {
    "tiny-test": ModelConfig.tiny_test,
    "llama3.2-1b": ModelConfig.llama32_1b,
}
