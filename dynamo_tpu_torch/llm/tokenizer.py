"""Tokenizers with incremental (streaming) decode (port of
dynamo_tpu/llm/tokenizer.py).

- ``HfTokenizer``: a model directory's ``tokenizer.json`` (read by
  llm/hf_tokenizer.py), its ``tokenizer_config.json`` chat template and
  eos token, and ``generation_config.json``'s eos ids;
- ``GgufTokenizer`` (llm/gguf.py): a ``.gguf`` file's embedded
  vocabulary;
- ``ToyTokenizer``: hermetic, byte-level, for presets.

A file's chat template renders with jinja2 (``trim_blocks``,
``lstrip_blocks``, ``raise_exception``), as the reference renders it.
The default template renders in plain Python, byte for byte as jinja2
renders ``DEFAULT_CHAT_TEMPLATE``: each message is
``<|role|>content</s>``, where a missing key renders as the empty string
and any other value as ``str(value)`` — a list-of-parts ``content``
prints as the Python list. A directory without ``tokenizer.json`` (the
reference's ``transformers`` fallback) is refused by name.
"""

from __future__ import annotations

import json
import os
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


class _DefaultChatTemplate:
    def render(self, messages: list[dict], add_generation_prompt: bool,
               tools: list[dict] | None = None) -> str:
        return render_default_chat_template(messages, add_generation_prompt)


class _JinjaChatTemplate:
    """A file's chat template, rendered by jinja2 as the reference
    renders it (jinja2 is imported here only: presets never need it)."""

    def __init__(self, template: str) -> None:
        import jinja2

        env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = _raise_exception
        self._template = env.from_string(template)

    def render(self, messages: list[dict], add_generation_prompt: bool,
               tools: list[dict] | None = None) -> str:
        return self._template.render(
            messages=messages, add_generation_prompt=add_generation_prompt, tools=tools,
        )


def _raise_exception(msg: str):
    raise ValueError(msg)


def chat_template(template: str | None):
    """The renderer of a file's template, or of the default one when the
    file has none."""
    return _JinjaChatTemplate(template) if template else _DefaultChatTemplate()


class HfTokenizer:
    """A model directory's ``tokenizer.json`` (+ ``tokenizer_config.json``
    for the chat template and eos token, + ``generation_config.json``'s
    eos ids)."""

    def __init__(self, model_dir: str | os.PathLike) -> None:
        from dynamo_tpu_torch.llm.hf_tokenizer import HfTokenizerJson

        model_dir = Path(model_dir)
        self._tok = HfTokenizerJson.from_file(model_dir / "tokenizer.json")
        self.vocab_size = self._tok.get_vocab_size()
        template: str | None = None
        eos_tokens: list[str] = []
        cfg_path = model_dir / "tokenizer_config.json"
        if cfg_path.exists():
            cfg = json.loads(cfg_path.read_text())
            template = cfg.get("chat_template")
            eos = cfg.get("eos_token")
            if isinstance(eos, dict):
                eos = eos.get("content")
            if eos:
                eos_tokens.append(eos)
        self._chat_template = chat_template(template)
        ids = [self._tok.token_to_id(t) for t in eos_tokens]
        gen_path = model_dir / "generation_config.json"
        if gen_path.exists():
            eos = json.loads(gen_path.read_text()).get("eos_token_id")
            ids += eos if isinstance(eos, list) else [eos]
        self.eos_token_ids = list(dict.fromkeys(int(i) for i in ids if i is not None))

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def decode_stream(self) -> IncrementalDecoder:
        return self._tok.decode_stream(skip_special_tokens=True)

    def apply_chat_template(
        self,
        messages: list[dict],
        add_generation_prompt: bool = True,
        tools: list[dict] | None = None,
    ) -> str:
        return self._chat_template.render(messages, add_generation_prompt, tools=tools)


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
    the ToyTokenizer, a ``.gguf`` its embedded vocabulary, a directory
    its ``tokenizer.json``."""
    if model_path in (None, "", "toy"):
        return ToyTokenizer()
    path = Path(model_path)
    if str(path).endswith(".gguf"):
        from dynamo_tpu_torch.llm.gguf import GgufTokenizer, read_gguf

        return GgufTokenizer(read_gguf(path, load_tensors_index=False))
    if (path / "tokenizer.json").exists():
        return HfTokenizer(path)
    raise RuntimeError(
        f"{model_path!r} has no tokenizer.json: a directory that only the "
        "`transformers` package could load is not served (ROADMAP C3)"
    )
