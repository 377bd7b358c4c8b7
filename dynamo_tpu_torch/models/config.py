"""Model architecture configs (port of dynamo_tpu/models/config.py).

The field list is the reference's, so a config describes the same model
in both packages. The port serves the dense families: the Llama trunk,
Qwen2's qkv bias and window gate, Qwen3's QK-norm, Mistral's sliding
window with its rolling buffer, and the Gemma-3 knobs (GeGLU, (1+w)
norms, sandwich norms, scaled embeddings, local/global windows with a
local rope base, the query scale fold). ``EngineConfig.validate``
refuses what it does not serve yet: MLA (with its yarn rope) and MoE,
and a model whose weights outgrow one card.
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

    @property
    def kv_cache_head_dim(self) -> int:
        """Per-head cache width (the dense families: the head dim)."""
        return self.head_dim

    @property
    def num_cache_heads(self) -> int:
        return self.num_kv_heads

    @property
    def rolling_buffer(self) -> bool:
        """True when EVERY layer is sliding-window attention, so KV blocks
        wholly behind the window can be released (Mistral's rolling
        buffer). One full-attention layer (Qwen2's max_window_layers > 0,
        a Gemma-3 global layer) pins the whole history."""
        return (
            bool(self.sliding_window)
            and self.max_window_layers == 0
            and self.window_pattern == 0
        )

    def param_count(self) -> int:
        """Weights of the dense trunk (embedding, layers, final norm, an
        untied head)."""
        D, H, kvH, hd = (
            self.hidden_size, self.num_heads, self.num_kv_heads, self.head_dim
        )
        layer = (
            D * H * hd + 2 * D * kvH * hd + H * hd * D   # q, k, v, o
            + 3 * D * self.intermediate_size             # gate, up, down
            + (4 if self.post_norms else 2) * D
        )
        if self.qkv_bias:
            layer += (H + 2 * kvH) * hd
        if self.qk_norm:
            layer += 2 * hd
        head = 0 if self.tie_word_embeddings else D * self.vocab_size
        return self.vocab_size * D + self.num_layers * layer + D + head

    def layer_window(self, layer_idx: int) -> int:
        """Sliding-window size for one layer (0 = full attention): Qwen2
        runs its first max_window_layers layers full; Gemma-3 makes every
        window_pattern-th layer global."""
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
        """Architecture features the port does not serve yet (ROADMAP
        A1b: MLA with its yarn rope, and MoE)."""
        out = []
        if self.is_mla:
            out.append("MLA (kv_lora_rank)")
        if self.is_moe:
            out.append("MoE (num_experts)")
        if self.rope_scaling is not None and self.rope_scaling.kind == "yarn":
            out.append("yarn rope scaling")
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

    @staticmethod
    def llama3_8b() -> "ModelConfig":
        return ModelConfig(
            name="llama3-8b",
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            max_position=8192,
        )

    @staticmethod
    def llama31_8b() -> "ModelConfig":
        from dynamo_tpu_torch.ops.rope import RopeScaling

        return ModelConfig(
            name="llama3.1-8b",
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            max_position=131072,
            rope_scaling=RopeScaling(
                factor=8.0,
                low_freq_factor=1.0,
                high_freq_factor=4.0,
                original_max_position=8192,
            ),
        )

    @staticmethod
    def llama3_70b() -> "ModelConfig":
        """Listed so that it resolves; its weights outgrow one card, and
        the engine refuses it (EngineConfig.validate)."""
        return ModelConfig(
            name="llama3-70b",
            vocab_size=128256,
            hidden_size=8192,
            intermediate_size=28672,
            num_layers=80,
            num_heads=64,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=500000.0,
            max_position=8192,
        )

    @staticmethod
    def qwen25_05b() -> "ModelConfig":
        """Qwen2.5-0.5B (HF Qwen/Qwen2.5-0.5B): qkv bias, tied head."""
        return ModelConfig(
            name="qwen2.5-0.5b",
            vocab_size=151936,
            hidden_size=896,
            intermediate_size=4864,
            num_layers=24,
            num_heads=14,
            num_kv_heads=2,
            head_dim=64,
            rope_theta=1000000.0,
            max_position=32768,
            tie_word_embeddings=True,
            qkv_bias=True,
        )

    @staticmethod
    def qwen3_06b() -> "ModelConfig":
        """Qwen3-0.6B (HF Qwen/Qwen3-0.6B): QK-norm, no qkv bias,
        explicit head_dim 128."""
        return ModelConfig(
            name="qwen3-0.6b",
            vocab_size=151936,
            hidden_size=1024,
            intermediate_size=3072,
            num_layers=28,
            num_heads=16,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=1000000.0,
            rms_eps=1e-6,
            max_position=40960,
            tie_word_embeddings=True,
            qk_norm=True,
        )

    @staticmethod
    def mistral_7b() -> "ModelConfig":
        """Mistral-7B-v0.1 (HF mistralai/Mistral-7B-v0.1): Llama-shaped
        with 4096-token sliding-window attention on every layer (a
        rolling buffer)."""
        return ModelConfig(
            name="mistral-7b",
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=10000.0,
            max_position=32768,
            sliding_window=4096,
        )

    @staticmethod
    def gemma3_1b() -> "ModelConfig":
        """Gemma-3 1B text (HF google/gemma-3-1b-pt config.json)."""
        return ModelConfig(
            name="gemma3-1b",
            vocab_size=262144,
            hidden_size=1152,
            intermediate_size=6912,
            num_layers=26,
            num_heads=4,
            num_kv_heads=1,
            head_dim=256,
            rope_theta=1_000_000.0,
            rms_eps=1e-6,
            max_position=32768,
            tie_word_embeddings=True,
            qk_norm=True,
            sliding_window=512,
            window_pattern=6,
            rope_local_theta=10000.0,
            hidden_act="gelu_tanh",
            norm_offset=True,
            post_norms=True,
            embed_scale=True,
            query_pre_attn_scalar=256.0,
        )

    @staticmethod
    def tiny_gemma_test(vocab_size: int = 384) -> "ModelConfig":
        """Hermetic Gemma-3-style test model: every family knob on, with a
        window pattern that has local AND global layers, and a query
        scalar unlike head_dim so the score-scale fold is a real
        multiplier."""
        return ModelConfig(
            name="tiny-gemma-test",
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=4,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            rope_theta=1_000_000.0,
            rms_eps=1e-6,
            max_position=512,
            tie_word_embeddings=True,
            qk_norm=True,
            sliding_window=32,
            window_pattern=2,
            rope_local_theta=10000.0,
            hidden_act="gelu_tanh",
            norm_offset=True,
            post_norms=True,
            embed_scale=True,
            query_pre_attn_scalar=32.0,
        )

    def scaled(self, **kwargs) -> "ModelConfig":
        return replace(self, **kwargs)


PRESETS = {
    "tiny-test": ModelConfig.tiny_test,
    "tiny-gemma-test": ModelConfig.tiny_gemma_test,
    "llama3.2-1b": ModelConfig.llama32_1b,
    "llama3-8b": ModelConfig.llama3_8b,
    "llama3.1-8b": ModelConfig.llama31_8b,
    "llama3-70b": ModelConfig.llama3_70b,
    "qwen2.5-0.5b": ModelConfig.qwen25_05b,
    "qwen3-0.6b": ModelConfig.qwen3_06b,
    "mistral-7b": ModelConfig.mistral_7b,
    "gemma3-1b": ModelConfig.gemma3_1b,
}
