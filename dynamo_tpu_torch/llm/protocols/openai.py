"""OpenAI-compatible API types (port of dynamo_tpu/llm/protocols/openai.py).

The reference declares these as pydantic models; the port declares them
as dataclasses with the same field names, defaults and order, and
validates request bodies with ``_Model.model_validate``, which reads the
dataclass annotations and coerces as pydantic's lax mode does for JSON
input: an integral float or a numeric string for an ``int`` field, a
number or numeric string for a ``float`` field, ``0``/``1`` or
``"yes"``/``"off"``-style strings for a ``bool`` field, nothing for a
``str`` field. A union takes the first member that accepts the value
without coercion, else the first that accepts it with coercion
(pydantic's "smart" union). Request models keep unknown fields
(``extra="allow"``); ``model_dump`` lists them after the declared ones.
An invalid body raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import functools
import re
import time
import types
import typing
import uuid
from dataclasses import dataclass, field
from typing import Any, ClassVar, Literal

from dynamo_tpu_torch.llm.protocols.common import SamplingOptions, StopConditions

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
# An int written as a string: digits with single underscores between
# them, optionally followed by a fraction of zeros ("5.000").
_INT_STR = re.compile(r"[+-]?\d+(?:_\d+)*(?:\.0+)?")
_INT_FROM_FLOAT_MAX = 2**63


class _Invalid(ValueError):
    def __init__(self, loc: tuple, msg: str) -> None:
        super().__init__(msg)
        self.loc = loc
        self.msg = msg


def _scalar(tp: type, v: Any, strict: bool, loc: tuple) -> Any:
    if tp is bool:
        if isinstance(v, bool):
            return v
        if not strict:
            if isinstance(v, (int, float)) and v in (0, 1):
                return bool(v)
            if isinstance(v, str) and v.lower() in _TRUE | _FALSE:
                return v.lower() in _TRUE
        raise _Invalid(loc, "Input should be a valid boolean")
    if tp is int:
        if isinstance(v, int) and not isinstance(v, bool):
            return v
        if not strict:
            if isinstance(v, bool):
                return int(v)
            if (isinstance(v, float) and v.is_integer()
                    and abs(v) < _INT_FROM_FLOAT_MAX):
                return int(v)
            if isinstance(v, str) and _INT_STR.fullmatch(v.strip()):
                return int(v.strip().split(".")[0].replace("_", ""))
        raise _Invalid(loc, "Input should be a valid integer")
    if tp is float:
        if isinstance(v, float):
            return v
        try:
            if isinstance(v, int) and not isinstance(v, bool):
                return float(v)
            if not strict:
                if isinstance(v, bool):
                    return float(v)
                if isinstance(v, str) and v.isascii():
                    return float(v)
        except (OverflowError, ValueError):
            pass
        raise _Invalid(loc, "Input should be a valid number")
    if tp is str:
        if isinstance(v, str):
            return v
        raise _Invalid(loc, "Input should be a valid string")
    raise TypeError(f"no validator for {tp!r}")


def _validate(tp: Any, v: Any, strict: bool, loc: tuple) -> Any:
    """``v`` as the annotation ``tp`` describes it, or ``_Invalid``."""
    if tp is Any:
        return v
    if tp is type(None):
        if v is None:
            return None
        raise _Invalid(loc, "Input should be None")
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin in (typing.Union, types.UnionType):
        if v is None and type(None) in args:
            return None
        members = [a for a in args if a is not type(None)]
        for mode in (True, False) if not strict else (True,):
            for member in members:
                try:
                    return _validate(member, v, mode, loc)
                except _Invalid:
                    continue
        raise _Invalid(loc, f"Input does not match any of {tp}")
    if origin is Literal:
        if v in args and type(v) in {type(a) for a in args}:
            return v
        raise _Invalid(loc, f"Input should be one of {args}")
    if origin is list:
        if not isinstance(v, list):
            raise _Invalid(loc, "Input should be a valid list")
        if args[0] in (bool, int, float, str) and all(type(x) is args[0] for x in v):
            return list(v)   # every item exact: accepted as is in either mode
        return [_validate(args[0], x, strict, loc + (i,)) for i, x in enumerate(v)]
    if origin is dict:
        if not isinstance(v, dict):
            raise _Invalid(loc, "Input should be a valid dictionary")
        return {
            _validate(args[0], k, strict, loc + (k,)):
                _validate(args[1], x, strict, loc + (k,))
            for k, x in v.items()
        }
    if isinstance(tp, type) and issubclass(tp, _Model):
        return tp._from(v, loc)
    return _scalar(tp, v, strict, loc)


def _dump(v: Any, exclude_none: bool) -> Any:
    if isinstance(v, _Model):
        return v.model_dump(exclude_none=exclude_none)
    if isinstance(v, list):
        return [_dump(x, exclude_none) for x in v]
    if isinstance(v, dict):
        return {k: _dump(x, exclude_none) for k, x in v.items()}
    return v


@functools.cache
def _hints(cls: type) -> dict[str, Any]:
    return typing.get_type_hints(cls)


class _Model:
    """Base of the dataclass models: validation from a dict and dumping
    back to one."""

    _extra_allowed: ClassVar[bool] = False
    _extra: ClassVar[dict[str, Any]] = {}   # per instance once validated

    @classmethod
    def model_validate(cls, obj: Any):
        try:
            return cls._from(obj, ())
        except _Invalid as exc:
            loc = ".".join(str(p) for p in exc.loc) or cls.__name__
            raise ValueError(
                f"1 validation error for {cls.__name__}\n{loc}\n  {exc.msg}"
            ) from None

    @classmethod
    def _from(cls, obj: Any, loc: tuple):
        if isinstance(obj, cls):
            return obj
        if not isinstance(obj, dict):
            raise _Invalid(
                loc, f"Input should be a valid dictionary or instance of {cls.__name__}"
            )
        hints = _hints(cls)
        values = {}
        for f in dataclasses.fields(cls):
            if f.name in obj:
                values[f.name] = _validate(
                    hints[f.name], obj[f.name], False, loc + (f.name,)
                )
            elif (f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING):
                raise _Invalid(loc + (f.name,), "Field required")
        out = cls(**values)
        if cls._extra_allowed:
            names = {f.name for f in dataclasses.fields(cls)}
            out._extra = {k: v for k, v in obj.items() if k not in names}
        return out

    def model_dump(self, exclude_none: bool = False) -> dict[str, Any]:
        items = [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)]
        items += list(self._extra.items())
        return {
            k: _dump(v, exclude_none)
            for k, v in items
            if not (exclude_none and v is None)
        }


@dataclass(kw_only=True)
class Ext(_Model):
    """Framework extension block (``ext``, or the reference's ``nvext``)."""

    _extra_allowed: ClassVar[bool] = True
    ignore_eos: bool | None = None
    use_raw_prompt: bool | None = None
    greedy: bool | None = None
    annotations: list[str] | None = None


@dataclass(kw_only=True)
class ChatMessage(_Model):
    _extra_allowed: ClassVar[bool] = True
    role: str
    content: str | list[dict[str, Any]] | None = None
    name: str | None = None
    tool_calls: list[dict[str, Any]] | None = None

    def text(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if isinstance(self.content, list):
            return "".join(
                part.get("text", "")
                for part in self.content
                if isinstance(part, dict) and part.get("type") == "text"
            )
        return ""


@dataclass(kw_only=True)
class _CommonRequest(_Model):
    _extra_allowed: ClassVar[bool] = True
    model: str
    stream: bool = False
    max_tokens: int | None = None
    max_completion_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    min_tokens: int | None = None
    seed: int | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    stop: str | list[str] | None = None
    n: int | None = None
    # chat: logprobs is a bool gate + top_logprobs the alternative count;
    # completions: logprobs IS the alternative count.
    logprobs: bool | int | None = None
    top_logprobs: int | None = None
    # Parsed so that they can be refused explicitly.
    best_of: int | None = None
    logit_bias: dict[str, float] | None = None
    ext: Ext | None = None
    nvext: Ext | None = None

    @property
    def extension(self) -> Ext | None:
        return self.ext or self.nvext

    def stop_conditions(self) -> StopConditions:
        stop = self.stop
        if stop is None:
            stop_list: list[str] = []
        elif isinstance(stop, str):
            stop_list = [stop]
        else:
            stop_list = list(stop)
        ext = self.extension
        return StopConditions(
            max_tokens=self.max_completion_tokens or self.max_tokens,
            stop=stop_list,
            min_tokens=self.min_tokens,
            ignore_eos=bool(ext.ignore_eos) if ext and ext.ignore_eos else False,
        )

    def sampling_options(self) -> SamplingOptions:
        ext = self.extension
        temperature = self.temperature
        if ext and ext.greedy:
            temperature = 0.0
        return SamplingOptions(
            temperature=temperature,
            top_p=self.top_p,
            top_k=self.top_k,
            seed=self.seed,
            frequency_penalty=self.frequency_penalty,
            presence_penalty=self.presence_penalty,
        )


@dataclass(kw_only=True)
class ChatCompletionRequest(_CommonRequest):
    messages: list[ChatMessage]
    tools: list[dict[str, Any]] | None = None
    tool_choice: Any | None = None


@dataclass(kw_only=True)
class CompletionRequest(_CommonRequest):
    prompt: str | list[str] | list[int] | list[list[int]]
    echo: bool | None = None


@dataclass(kw_only=True)
class EmbeddingRequest(_Model):
    """Validated so that /v1/embeddings answers as the reference does
    for a model it does not serve."""

    _extra_allowed: ClassVar[bool] = True
    model: str
    input: str | list[str] | list[int] | list[list[int]]
    encoding_format: Literal["float", "base64"] = "float"


@dataclass(kw_only=True)
class Usage(_Model):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


@dataclass(kw_only=True)
class ChatDelta(_Model):
    role: str | None = None
    content: str | None = None
    tool_calls: list[dict[str, Any]] | None = None


@dataclass(kw_only=True)
class StreamChoice(_Model):
    index: int = 0
    delta: ChatDelta
    logprobs: dict[str, Any] | None = None
    finish_reason: str | None = None


def _now() -> int:
    return int(time.time())


@dataclass(kw_only=True)
class ChatCompletionChunk(_Model):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int = field(default_factory=_now)
    model: str
    choices: list[StreamChoice]
    usage: Usage | None = None


@dataclass(kw_only=True)
class Choice(_Model):
    index: int = 0
    message: ChatMessage
    logprobs: dict[str, Any] | None = None
    finish_reason: str | None = None


@dataclass(kw_only=True)
class ChatCompletionResponse(_Model):
    id: str
    object: Literal["chat.completion"] = "chat.completion"
    created: int = field(default_factory=_now)
    model: str
    choices: list[Choice]
    usage: Usage = field(default_factory=Usage)


@dataclass(kw_only=True)
class CompletionChoice(_Model):
    index: int = 0
    text: str
    logprobs: dict[str, Any] | None = None
    finish_reason: str | None = None


@dataclass(kw_only=True)
class CompletionResponse(_Model):
    id: str
    object: Literal["text_completion"] = "text_completion"
    created: int = field(default_factory=_now)
    model: str
    choices: list[CompletionChoice]
    usage: Usage = field(default_factory=Usage)


@dataclass(kw_only=True)
class ModelInfo(_Model):
    id: str
    object: Literal["model"] = "model"
    created: int = field(default_factory=_now)
    owned_by: str = "dynamo-tpu"


@dataclass(kw_only=True)
class ModelList(_Model):
    object: Literal["list"] = "list"
    data: list[ModelInfo] = field(default_factory=list)


def new_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"
