"""LocalModel: resolve a model reference into config, card and weights
(port of dynamo_tpu/llm/local_model.py). Accepted references:

- ``preset:NAME`` — an architecture preset of models/config.py with
  seeded random weights and the hermetic ToyTokenizer;
- a local directory — an HF checkout: ``config.json``, ``*.safetensors``
  (with or without ``model.safetensors.index.json``) and tokenizer files;
- ``hf://org/name`` — resolved through the local HF hub cache
  (``HF_HOME``/``~/.cache/huggingface``); nothing is downloaded, so the
  snapshot must be there already;
- ``FILE.gguf`` — a GGUF file: its metadata gives the config, its
  embedded vocabulary the tokenizer, its F32/F16/BF16 tensors the
  weights.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models.config import PRESETS, ModelConfig

logger = logging.getLogger(__name__)


def _hub_cache_dirs() -> list[Path]:
    home = os.environ.get("HF_HOME")
    roots = [Path(home) / "hub"] if home else []
    roots.append(Path.home() / ".cache" / "huggingface" / "hub")
    return roots


def resolve_hub_snapshot(repo_id: str) -> str:
    """The newest cached snapshot of ``org/name`` that has a config.json
    (offline: the hub is never contacted)."""
    folder = "models--" + repo_id.replace("/", "--")
    for root in _hub_cache_dirs():
        snaps = root / folder / "snapshots"
        if snaps.is_dir():
            revs = sorted(snaps.iterdir(), key=lambda p: p.stat().st_mtime)
            for rev in reversed(revs):
                if (rev / "config.json").exists():
                    return str(rev)
    raise FileNotFoundError(
        f"hf://{repo_id} not in the local hub cache "
        f"(searched {[str(r) for r in _hub_cache_dirs()]}); "
        "pre-download it or pass a local directory"
    )


@dataclass
class LocalModel:
    name: str
    config: ModelConfig
    model_path: str | None  # checkout dir or .gguf; None = preset
    card: ModelDeploymentCard

    @staticmethod
    def prepare(
        ref: str,
        name: str | None = None,
        context_length: int | None = None,
        kv_block_size: int = 16,
    ) -> "LocalModel":
        model_path: str | None
        if ref.startswith("preset:"):
            preset = ref.split(":", 1)[1]
            if preset not in PRESETS:
                raise ValueError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
            config = PRESETS[preset]()
            model_path = None
            name = name or preset
        elif ref.endswith(".gguf"):
            from dynamo_tpu_torch.llm.gguf import model_config_from_gguf, read_gguf

            if not Path(ref).exists():
                raise FileNotFoundError(ref)
            config = model_config_from_gguf(read_gguf(ref))
            model_path = ref  # load_tokenizer serves the embedded vocabulary
            name = name or Path(ref).stem
        else:
            if ref.startswith("hf://"):
                model_path = resolve_hub_snapshot(ref[len("hf://"):])
            else:
                model_path = ref
                if not (Path(model_path) / "config.json").exists():
                    raise FileNotFoundError(
                        f"{model_path} has no config.json (expected an HF "
                        "checkout, a .gguf file, 'preset:NAME', or "
                        "'hf://org/name')"
                    )
            config = ModelConfig.from_hf(model_path)
            name = name or Path(ref.rstrip("/")).name
        card = ModelDeploymentCard(
            name=name,
            model_path=model_path,  # None → ToyTokenizer (load_tokenizer)
            context_length=min(context_length or config.max_position, config.max_position),
            kv_block_size=kv_block_size,
        )
        return LocalModel(name=name, config=config, model_path=model_path, card=card)

    def load_params(self, dtype="bfloat16", device=None):
        """The checkpoint's weights ([in, out]) in ``dtype`` on ``device``
        (default: the card), or None for a preset (the runner seeds
        random weights on the device)."""
        if self.model_path is None:
            return None
        logger.info("loading weights from %s", self.model_path)
        if self.model_path.endswith(".gguf"):
            from dynamo_tpu_torch.llm.gguf import load_gguf_weights, read_gguf

            return load_gguf_weights(
                self.config, read_gguf(self.model_path), dtype=dtype, device=device
            )
        from dynamo_tpu_torch.models import llama

        return llama.load_hf_weights(self.config, self.model_path, dtype=dtype, device=device)
