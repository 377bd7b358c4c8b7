"""Model architecture configs (port of dynamo_tpu/models/config.py).

The field list is the reference's, so a config describes the same model
in both packages. The port serves the dense families: the Llama trunk,
Qwen2's qkv bias and window gate, Qwen3's QK-norm, Mistral's sliding
window with its rolling buffer, the Gemma-3 knobs (GeGLU, (1+w)
norms, sandwich norms, scaled embeddings, local/global windows with a
local rope base, the query scale fold), and the DeepSeek family: MLA's
latent cache with its yarn rope, and Mixtral/DeepSeek routed experts
with DeepSeek's shared experts and dense leading layers.
``EngineConfig.validate`` refuses a model whose weights outgrow one
card (``param_count``). ``ModelConfig.from_hf`` reads a checkout's
``config.json`` as the reference does; ``to_hf_config`` is its inverse,
for writing checkouts (test fixtures, the chip check).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path


def _rope_scaling(d):
    from dynamo_tpu_torch.ops.rope import RopeScaling

    return RopeScaling.from_hf(d)


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
        """Per-head cache width: the head dim, or MLA's one shared entry
        [latent ‖ roped k_pe] of kv_lora_rank + qk_rope_head_dim."""
        return (
            self.kv_lora_rank + self.qk_rope_head_dim
            if self.is_mla
            else self.head_dim
        )

    @property
    def num_cache_heads(self) -> int:
        return 1 if self.is_mla else self.num_kv_heads

    def moe_layer(self, layer_idx: int) -> bool:
        """Does this layer use the routed-experts MLP (DeepSeek keeps its
        first first_k_dense_replace layers dense)?"""
        return self.is_moe and layer_idx >= self.first_k_dense_replace

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
        """Weights of the model as ``init_params`` makes them: embedding,
        per layer the attention (GQA projections, or MLA's down/up
        projections and norms) and the MLP (a dense SwiGLU, or a router
        with its routed and shared experts), the final norm and an untied
        head."""
        D, H, kvH, hd = (
            self.hidden_size, self.num_heads, self.num_kv_heads, self.head_dim
        )
        if self.is_mla:
            dn, dr, dc = self.qk_nope_head_dim, self.qk_rope_head_dim, self.kv_lora_rank
            attn = (
                D * (dc + dr) + dc                          # w_dkv, ln_kv
                + H * dn * dc + H * self.v_head_dim * dc    # w_uk, w_uv
                + H * self.v_head_dim * D                   # wo
            )
            if self.q_lora_rank:
                attn += D * self.q_lora_rank + self.q_lora_rank  # w_dq, ln_q
                attn += self.q_lora_rank * H * (dn + dr)         # w_uq
            else:
                attn += D * H * (dn + dr)                        # wq
        else:
            attn = D * H * hd + 2 * D * kvH * hd + H * hd * D   # q, k, v, o
            if self.qkv_bias:
                attn += (H + 2 * kvH) * hd
            if self.qk_norm:
                attn += 2 * hd
        norms = (4 if self.post_norms else 2) * D
        dense_mlp = 3 * D * self.intermediate_size
        Im = self.moe_intermediate_size or self.intermediate_size
        moe_mlp = (
            D * self.num_experts                             # w_router
            + (self.num_experts if self.gating == "sigmoid" else 0)
            + self.num_experts * 3 * D * Im                  # routed experts
            + 3 * D * Im * self.n_shared_experts             # shared experts
        )
        layers = sum(
            attn + norms + (moe_mlp if self.moe_layer(li) else dense_mlp)
            for li in range(self.num_layers)
        )
        head = 0 if self.tie_word_embeddings else D * self.vocab_size
        return self.vocab_size * D + layers + D + head

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

    @staticmethod
    def from_hf(model_dir: str) -> "ModelConfig":
        cfg = json.loads((Path(model_dir) / "config.json").read_text())
        arch = (cfg.get("architectures") or ["LlamaForCausalLM"])[0]
        if arch.startswith("Gemma2") or cfg.get("attn_logit_softcapping"):
            raise NotImplementedError(
                "Gemma-2 attention-logit softcapping is not implemented; "
                "the Gemma-3 family (softcap-free) is supported"
            )
        if arch.startswith("Gemma3") or "gemma3" in cfg.get("model_type", ""):
            if "text_config" in cfg:  # multimodal wrapper config
                cfg = {**cfg["text_config"],
                       "model_type": cfg.get("model_type", "gemma3")}
            return ModelConfig._from_hf_gemma3(cfg)
        num_heads = cfg["num_attention_heads"]
        hidden = cfg["hidden_size"]
        deepseek = "Deepseek" in arch or "deepseek" in cfg.get("model_type", "")
        return ModelConfig(
            name=cfg.get("model_type", "llama"),
            vocab_size=cfg["vocab_size"],
            hidden_size=hidden,
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=cfg.get("num_key_value_heads", num_heads),
            head_dim=cfg.get("head_dim", hidden // num_heads),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position=cfg.get("max_position_embeddings", 8192),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            qkv_bias="Qwen2" in arch,
            qk_norm="Qwen3" in arch,
            # Mistral carries sliding_window unconditionally (null = full
            # attention in v0.2+); Qwen2 gates it behind use_sliding_window.
            sliding_window=int(cfg.get("sliding_window") or 0)
            if cfg.get("use_sliding_window", True)
            else 0,
            max_window_layers=int(cfg.get("max_window_layers") or 0)
            if cfg.get("use_sliding_window", True)
            else 0,
            # DeepSeek uses n_routed_experts; Mixtral num_local_experts.
            num_experts=cfg.get(
                "n_routed_experts", cfg.get("num_local_experts", 0)
            ) or 0,
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
            rope_scaling=_rope_scaling(cfg.get("rope_scaling")),
            kv_lora_rank=(cfg.get("kv_lora_rank") or 0) if deepseek else 0,
            q_lora_rank=(cfg.get("q_lora_rank") or 0) if deepseek else 0,
            qk_nope_head_dim=cfg.get("qk_nope_head_dim", 128),
            qk_rope_head_dim=cfg.get("qk_rope_head_dim", 64),
            v_head_dim=cfg.get("v_head_dim", cfg.get("head_dim", hidden // num_heads)),
            n_shared_experts=cfg.get("n_shared_experts", 0) or 0,
            moe_intermediate_size=cfg.get("moe_intermediate_size", 0) or 0,
            first_k_dense_replace=cfg.get("first_k_dense_replace", 0) or 0,
            gating="sigmoid" if cfg.get("scoring_func") == "sigmoid" else "softmax",
            norm_topk_prob=cfg.get("norm_topk_prob", True),
            routed_scaling_factor=cfg.get("routed_scaling_factor", 1.0),
            n_group=cfg.get("n_group", 1) or 1,
            topk_group=cfg.get("topk_group", 1) or 1,
        )

    @staticmethod
    def _from_hf_gemma3(cfg: dict) -> "ModelConfig":
        """HF Gemma3TextConfig → ModelConfig (Gemma-3 1B/4B/12B/27B text
        trunk: GeGLU, (1+w) norms, sandwich norms, scaled embeddings,
        QK-norm, 5-local:1-global window pattern with a separate local
        rope base)."""
        if cfg.get("final_logit_softcapping") or cfg.get(
            "attn_logit_softcapping"
        ):
            raise NotImplementedError(
                "Gemma logit softcapping is not implemented"
            )
        # Published multimodal checkpoints (gemma-3-4b/12b/27b) ship SPARSE
        # text_configs that rely on HF Gemma3TextConfig defaults — fill
        # them in (values from transformers Gemma3TextConfig()).
        defaults = {
            "vocab_size": 262208,
            "hidden_size": 2304,
            "intermediate_size": 9216,
            "num_hidden_layers": 26,
            "num_attention_heads": 8,
            "num_key_value_heads": 4,
            "head_dim": 256,
            "rope_theta": 1_000_000.0,
            "rope_local_base_freq": 10_000.0,
            "sliding_window": 4096,
            "sliding_window_pattern": 6,
            "rms_norm_eps": 1e-6,
            "max_position_embeddings": 131072,
            "tie_word_embeddings": True,
            "query_pre_attn_scalar": 256,
        }
        cfg = {**defaults, **{k: v for k, v in cfg.items() if v is not None}}
        # The global/local layer plan ships either as sliding_window_pattern
        # (config.json) or as an explicit layer_types list (newer HF).
        pattern = int(cfg.get("sliding_window_pattern") or 0)
        lt = cfg.get("layer_types")
        if lt and "full_attention" in lt:
            pattern = lt.index("full_attention") + 1
        return ModelConfig(
            name=cfg.get("model_type", "gemma3"),
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg["head_dim"],
            rope_theta=cfg["rope_theta"],
            rms_eps=cfg["rms_norm_eps"],
            max_position=cfg["max_position_embeddings"],
            tie_word_embeddings=cfg["tie_word_embeddings"],
            qk_norm=True,
            sliding_window=int(cfg["sliding_window"] or 0),
            window_pattern=pattern,
            rope_local_theta=float(cfg["rope_local_base_freq"] or 0.0),
            rope_scaling=_rope_scaling(cfg.get("rope_scaling")),
            hidden_act="gelu_tanh",
            norm_offset=True,
            post_norms=True,
            embed_scale=True,
            query_pre_attn_scalar=float(cfg["query_pre_attn_scalar"] or 0.0),
        )

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

    @staticmethod
    def tiny_moe_test(vocab_size: int = 384) -> "ModelConfig":
        """Hermetic Mixtral-style MoE test model."""
        return ModelConfig(
            name="tiny-moe-test",
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=96,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            rope_theta=10000.0,
            max_position=512,
            num_experts=4,
            num_experts_per_tok=2,
        )

    @staticmethod
    def tiny_mla_test(vocab_size: int = 384) -> "ModelConfig":
        """Hermetic DeepSeek-style test model: MLA + shared/routed experts
        with sigmoid gating and one leading dense layer (the V3/R1 layer
        plan in miniature)."""
        return ModelConfig(
            name="tiny-mla-test",
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=3,
            num_heads=4,
            num_kv_heads=4,
            head_dim=16,
            rope_theta=10000.0,
            max_position=512,
            kv_lora_rank=32,
            q_lora_rank=48,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            num_experts=4,
            num_experts_per_tok=2,
            n_shared_experts=1,
            moe_intermediate_size=48,
            first_k_dense_replace=1,
            gating="sigmoid",
            routed_scaling_factor=2.5,
        )

    @staticmethod
    def _deepseek_yarn(mscale: float) -> "object":
        from dynamo_tpu_torch.ops.rope import RopeScaling

        return RopeScaling(
            kind="yarn",
            factor=40.0,
            original_max_position=4096,
            beta_fast=32.0,
            beta_slow=1.0,
            mscale=mscale,
            mscale_all_dim=mscale,
        )

    @staticmethod
    def deepseek_v2_lite() -> "ModelConfig":
        """DeepSeek-V2-Lite 15.7B (HF deepseek-ai/DeepSeek-V2-Lite: MLA
        without q-lora, 64 routed experts top-6 with softmax gating, 2
        shared experts, one leading dense layer, yarn rope)."""
        return ModelConfig(
            name="deepseek-v2-lite",
            vocab_size=102400,
            hidden_size=2048,
            intermediate_size=10944,
            num_layers=27,
            num_heads=16,
            num_kv_heads=16,
            head_dim=128,
            rope_theta=10000.0,
            max_position=163840,
            kv_lora_rank=512,
            q_lora_rank=0,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            num_experts=64,
            num_experts_per_tok=6,
            n_shared_experts=2,
            moe_intermediate_size=1408,
            first_k_dense_replace=1,
            gating="softmax",
            norm_topk_prob=False,
            routed_scaling_factor=1.0,
            n_group=1,
            topk_group=1,
            rope_scaling=ModelConfig._deepseek_yarn(0.707),
        )

    @staticmethod
    def deepseek_r1() -> "ModelConfig":
        """DeepSeek-R1/V3 671B (MLA + q-lora, sigmoid gating over 256
        experts in 8 groups). Listed so that it resolves; its weights
        outgrow one card, and the engine refuses it."""
        return ModelConfig(
            name="deepseek-r1",
            vocab_size=129280,
            hidden_size=7168,
            intermediate_size=18432,
            num_layers=61,
            num_heads=128,
            num_kv_heads=128,
            head_dim=128,
            rope_theta=10000.0,
            max_position=163840,
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
            num_experts=256,
            num_experts_per_tok=8,
            n_shared_experts=1,
            moe_intermediate_size=2048,
            first_k_dense_replace=3,
            gating="sigmoid",
            norm_topk_prob=True,
            routed_scaling_factor=2.5,
            n_group=8,
            topk_group=4,
            rope_scaling=ModelConfig._deepseek_yarn(1.0),
        )

    @staticmethod
    def mixtral_8x7b() -> "ModelConfig":
        """Mixtral-8x7B (8 experts top-2 on every layer). Listed so that
        it resolves; its ~93 GB of bf16 weights outgrow one card, and
        the engine refuses it."""
        return ModelConfig(
            name="mixtral-8x7b",
            vocab_size=32000,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=1e6,
            max_position=32768,
            num_experts=8,
            num_experts_per_tok=2,
        )

    def scaled(self, **kwargs) -> "ModelConfig":
        return replace(self, **kwargs)


PRESETS = {
    "tiny-test": ModelConfig.tiny_test,
    "tiny-gemma-test": ModelConfig.tiny_gemma_test,
    "tiny-moe-test": ModelConfig.tiny_moe_test,
    "tiny-mla-test": ModelConfig.tiny_mla_test,
    "deepseek-v2-lite": ModelConfig.deepseek_v2_lite,
    "deepseek-r1": ModelConfig.deepseek_r1,
    "mixtral-8x7b": ModelConfig.mixtral_8x7b,
    "llama3.2-1b": ModelConfig.llama32_1b,
    "llama3-8b": ModelConfig.llama3_8b,
    "llama3.1-8b": ModelConfig.llama31_8b,
    "llama3-70b": ModelConfig.llama3_70b,
    "qwen2.5-0.5b": ModelConfig.qwen25_05b,
    "qwen3-0.6b": ModelConfig.qwen3_06b,
    "mistral-7b": ModelConfig.mistral_7b,
    "gemma3-1b": ModelConfig.gemma3_1b,
}


def _rope_scaling_json(sc) -> dict | None:
    if sc is None:
        return None
    if sc.kind == "llama3":
        return {"rope_type": "llama3", "factor": sc.factor,
                "low_freq_factor": sc.low_freq_factor,
                "high_freq_factor": sc.high_freq_factor,
                "original_max_position_embeddings": sc.original_max_position}
    if sc.kind == "linear":
        return {"rope_type": "linear", "factor": sc.factor}
    return {"rope_type": "yarn", "factor": sc.factor,
            "original_max_position_embeddings": sc.original_max_position,
            "beta_fast": sc.beta_fast, "beta_slow": sc.beta_slow,
            "mscale": sc.mscale, "mscale_all_dim": sc.mscale_all_dim}


def to_hf_config(cfg: ModelConfig) -> dict:
    """The ``config.json`` that ``ModelConfig.from_hf`` reads back as
    ``cfg`` (its ``name`` becomes the ``model_type``)."""
    common = {
        "model_type": cfg.name, "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
        "max_position_embeddings": cfg.max_position,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "rope_scaling": _rope_scaling_json(cfg.rope_scaling),
    }
    if cfg.post_norms:
        return {**common, "architectures": ["Gemma3ForCausalLM"],
                "sliding_window": cfg.sliding_window,
                "sliding_window_pattern": cfg.window_pattern,
                "rope_local_base_freq": cfg.rope_local_theta,
                "query_pre_attn_scalar": cfg.query_pre_attn_scalar,
                "hidden_activation": "gelu_pytorch_tanh"}
    if cfg.is_mla:
        arch = "DeepseekV3ForCausalLM"
    elif cfg.is_moe:
        arch = "MixtralForCausalLM"
    elif cfg.qk_norm:
        arch = "Qwen3ForCausalLM"
    elif cfg.qkv_bias:
        arch = "Qwen2ForCausalLM"
    else:
        arch = "LlamaForCausalLM"
    out = {**common, "architectures": [arch],
           "sliding_window": cfg.sliding_window or None,
           "max_window_layers": cfg.max_window_layers,
           "num_experts_per_tok": cfg.num_experts_per_tok, "v_head_dim": cfg.v_head_dim}
    if cfg.is_moe:
        out["n_routed_experts" if cfg.is_mla else "num_local_experts"] = cfg.num_experts
    if cfg.is_mla:
        out.update(
            kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank or None,
            qk_nope_head_dim=cfg.qk_nope_head_dim, qk_rope_head_dim=cfg.qk_rope_head_dim,
            n_shared_experts=cfg.n_shared_experts,
            moe_intermediate_size=cfg.moe_intermediate_size,
            first_k_dense_replace=cfg.first_k_dense_replace,
            scoring_func="sigmoid" if cfg.gating == "sigmoid" else "softmax",
            norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor,
            n_group=cfg.n_group, topk_group=cfg.topk_group,
        )
    return out
