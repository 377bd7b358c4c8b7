"""Tokenizers with incremental (streaming) decode (port of
dynamo_tpu/llm/tokenizer.py).

This slice serves the hermetic byte-level ``ToyTokenizer`` and renders
the default chat template in plain Python, byte for byte as jinja2
renders ``DEFAULT_CHAT_TEMPLATE`` (with ``trim_blocks`` and
``lstrip_blocks``): each message is ``<|role|>content</s>``, where a
missing key renders as the empty string and any other value as
``str(value)`` — a list-of-parts ``content`` prints as the Python list.
Tokenizers read from model files (HF ``tokenizer.json``, a directory
``transformers`` would load, a GGUF vocabulary) wait for the slice that
loads checkpoint weights; ``load_tokenizer`` refuses them by name.
"""

from __future__ import annotations

from pathlib import Path
from typing import Protocol, Sequence

DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message.role }}|>{{ message.content }}</s>"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|assistant|>{% endif %}"
)


class Tokenizer(Protocol):
    eos_token_ids: list[int]
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def decode_stream(self) -> "IncrementalDecoder": ...
    def apply_chat_template(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: list[dict] | None = None,
    ) -> str: ...


class IncrementalDecoder(Protocol):
    def step(self, token_id: int) -> str | None: ...


def render_default_chat_template(
    messages: list[dict], add_generation_prompt: bool = True
) -> str:
    """``DEFAULT_CHAT_TEMPLATE`` rendered without jinja2 (``tools`` is not
    referenced by the template)."""

    def field(message: dict, key: str) -> str:
        return str(message[key]) if key in message else ""

    out = [
        f"<|{field(m, 'role')}|>{field(m, 'content')}</s>" for m in messages
    ]
    if add_generation_prompt:
        out.append("<|assistant|>")
    return "".join(out)


class ToyTokenizer:
    """Hermetic byte-level tokenizer: token id == utf-8 byte.

    Reversible, exercises partial-UTF-8 incremental decode, needs no
    files. Ids 0..255 are bytes; 256 is <eos>; larger ids decode to
    nothing.
    """

    EOS = 256

    def __init__(self) -> None:
        self.eos_token_ids = [self.EOS]
        self.vocab_size = 257

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def decode_stream(self) -> IncrementalDecoder:
        class _Stream:
            def __init__(self) -> None:
                self._buf = b""

            def step(self, token_id: int) -> str | None:
                if not 0 <= token_id < 256:
                    return None
                self._buf += bytes([token_id])
                try:
                    text = self._buf.decode("utf-8")
                except UnicodeDecodeError:
                    return None  # hold partial multi-byte sequence
                self._buf = b""
                return text

        return _Stream()

    def apply_chat_template(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: list[dict] | None = None,
    ) -> str:
        return render_default_chat_template(messages, add_generation_prompt)


def load_tokenizer(model_path: str | None) -> Tokenizer:
    """The tokenizer for a model path: ``None``, ``""`` or ``"toy"`` give
    the ToyTokenizer; model files raise, naming what their tokenizer
    needs."""
    if model_path in (None, "", "toy"):
        return ToyTokenizer()
    path = Path(model_path)
    if str(path).endswith(".gguf"):
        need = "the GGUF vocabulary reader"
    elif (path / "tokenizer.json").exists():
        need = "the `tokenizers` package"
    else:
        need = "the `transformers` package"
    raise RuntimeError(
        f"tokenizer for {model_path!r} needs {need}, which dynamo_tpu_torch "
        "does not use yet: this slice serves the toy tokenizer (model "
        "path None or 'toy'); tokenizers from model files arrive with "
        "checkpoint loading"
    )
