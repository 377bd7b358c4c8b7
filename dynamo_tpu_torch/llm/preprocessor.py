"""OpenAI preprocessor operator (port of dynamo_tpu/llm/preprocessor.py).

Forward path: OpenAI chat/completion request → prompt templating →
tokenization → ``PreprocessedRequest`` wire dict. Backward path:
detokenized EngineOutput deltas → OpenAI stream chunks, with a final
usage-bearing chunk; requested annotations (``formatted_prompt``,
``token_ids``) ride ahead of the first delta, with ``tools`` the text
is matched for tool calls, and the engine's logprob entries render in
the OpenAI chat and legacy completions shapes.

Tokenization is the request's ``tokenize`` span. The deadline and the
SLO class the HTTP boundary put on the Context's annotations, and the
trace context, ride the ``PreprocessedRequest`` wire to every later hop;
a request shed or expired before any output surfaces as a typed error
(``ShedError``, ``DeadlineError``), not an empty completion.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm import slo
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.annotated import Annotated
from dynamo_tpu_torch.llm.protocols.common import (
    MAX_LOGPROBS,
    DeadlineError,
    EngineOutput,
    FinishReason,
    PreprocessedRequest,
    RequestError,
    ShedError,
)
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatDelta,
    CompletionRequest,
    StreamChoice,
    Usage,
    new_request_id,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.llm.tools import ToolCallMatcher
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.utils.tracing import tracer
from dynamo_tpu_torch.runtime.pipeline import Operator

ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"


class OpenAIPreprocessor(Operator):
    def __init__(self, card: ModelDeploymentCard, tokenizer: Tokenizer) -> None:
        self.card = card
        self.tokenizer = tokenizer

    # -- forward ------------------------------------------------------------
    def preprocess(
        self, request: ChatCompletionRequest | CompletionRequest
    ) -> PreprocessedRequest:
        ext = request.extension
        if isinstance(request, ChatCompletionRequest):
            if ext and ext.use_raw_prompt:
                prompt = "".join(m.text() for m in request.messages)
            else:
                tools = (
                    request.tools if request.tool_choice != "none" else None
                )
                prompt = self.tokenizer.apply_chat_template(
                    [m.model_dump(exclude_none=True) for m in request.messages],
                    tools=tools,
                )
            token_ids = self.tokenizer.encode(prompt)
        else:
            p = request.prompt
            if isinstance(p, str):
                prompt = p
                token_ids = self.tokenizer.encode(p)
            elif p and isinstance(p[0], int):
                prompt = None
                token_ids = list(p)  # pre-tokenized prompt
            else:
                raise RequestError("batch prompts unsupported; send one prompt")

        stop = request.stop_conditions()
        if not stop.ignore_eos:
            stop.stop_token_ids = list(
                dict.fromkeys(stop.stop_token_ids + self.tokenizer.eos_token_ids)
            )
        budget = self.card.context_length - len(token_ids)
        if budget <= 0:
            raise RequestError(
                f"prompt ({len(token_ids)} tokens) exceeds context length "
                f"{self.card.context_length}"
            )
        stop.max_tokens = min(stop.max_tokens or budget, budget)

        if request.n is not None and request.n > 1:
            raise RequestError("n > 1 is not supported")
        if request.best_of is not None and request.best_of > 1:
            raise RequestError("best_of > 1 is not supported")
        if request.logit_bias:
            raise RequestError("logit_bias is not supported")

        # Logprobs: chat uses a bool gate + top_logprobs count; completions
        # an integer count, where 0 is a valid value.
        logprobs: int | None = None
        if isinstance(request, ChatCompletionRequest):
            if request.logprobs:
                logprobs = int(request.top_logprobs or 0)
        elif request.logprobs is not None and request.logprobs is not False:
            logprobs = int(request.logprobs)
        if logprobs is not None and logprobs > MAX_LOGPROBS:
            raise RequestError(
                f"top_logprobs={logprobs} exceeds the supported maximum "
                f"of {MAX_LOGPROBS}"
            )

        pre = PreprocessedRequest(
            token_ids=token_ids,
            sampling=request.sampling_options(),
            stop=stop,
            model=request.model,
            logprobs=logprobs,
        )
        if prompt is not None:
            pre.annotations[ANNOTATION_FORMATTED_PROMPT] = prompt
        return pre

    async def preprocess_async(
        self, request: ChatCompletionRequest | CompletionRequest
    ) -> PreprocessedRequest:
        """The forward path as the operator runs it: a subclass that must
        await a service while preprocessing (the multimodal encode worker,
        llm/multimodal.py) overrides this; here it is ``preprocess``."""
        return self.preprocess(request)

    # -- logprob rendering ---------------------------------------------------
    def _tok_str(self, token_id: int) -> str:
        return self.tokenizer.decode([token_id])

    def _chat_logprobs(self, entries: list[dict]) -> dict:
        """OpenAI chat shape: {"content": [{token, logprob, bytes,
        top_logprobs: [...]}, ...]}."""
        content = []
        for e in entries:
            tok = self._tok_str(e["id"])
            content.append({
                "token": tok,
                "logprob": e["logprob"],
                "bytes": list(tok.encode("utf-8")),
                "top_logprobs": [
                    {
                        "token": (t := self._tok_str(i)),
                        "logprob": lp,
                        "bytes": list(t.encode("utf-8")),
                    }
                    for i, lp in e.get("top", [])
                ],
            })
        return {"content": content}

    def _completion_logprobs(
        self, entries: list[dict], text_offset: int
    ) -> tuple[dict, int]:
        """Legacy completions shape: parallel lists tokens /
        token_logprobs / top_logprobs / text_offset."""
        tokens, token_lps, top, offsets = [], [], [], []
        for e in entries:
            tok = self._tok_str(e["id"])
            tokens.append(tok)
            token_lps.append(e["logprob"])
            top.append(
                {self._tok_str(i): lp for i, lp in e.get("top", [])} or None
            )
            offsets.append(text_offset)
            text_offset += len(tok)
        return (
            {
                "tokens": tokens,
                "token_logprobs": token_lps,
                "top_logprobs": top,
                "text_offset": offsets,
            },
            text_offset,
        )

    # -- operator -----------------------------------------------------------
    async def generate(
        self, request: Context, downstream: AsyncEngine
    ) -> AsyncIterator[Any]:
        oai: ChatCompletionRequest | CompletionRequest = request.payload
        with tracer().span(request.id, "tokenize"):
            pre = await self.preprocess_async(oai)
        # The HTTP boundary parsed or defaulted the deadline and the class
        # onto the Context; from here they ride the wire.
        pre.deadline = request.annotations.get("deadline")
        cls = request.annotations.get(slo.ANNOTATION_KEY)
        if cls is not None:
            pre.annotations[slo.ANNOTATION_KEY] = cls
        pre.trace = tracer().context(request.id, parent_span="tokenize")
        is_chat = isinstance(oai, ChatCompletionRequest)
        rid = new_request_id("chatcmpl" if is_chat else "cmpl")
        prompt_tokens = len(pre.token_ids)

        ext = oai.extension
        for name in (ext.annotations if ext and ext.annotations else ()):
            if name == ANNOTATION_TOKEN_IDS:
                yield Annotated.annotation(name, list(pre.token_ids), rid)
            elif name in pre.annotations:
                yield Annotated.annotation(name, pre.annotations[name], rid)

        # With tools in play the content is inspected whole: deltas buffer
        # until the text can no longer open a tool-call JSON, or until the
        # finish, which emits one content-or-tool_calls chunk.
        matcher = None
        if is_chat and oai.tools:
            m = ToolCallMatcher(oai.tool_choice or "auto")
            matcher = m if m.enabled else None
        buffered: list[str] = []
        buffered_lp: list[dict] = []  # logprob entries held with the text
        text_offset = 0  # completions logprobs: offset in the generated text

        def tool_chunk(fallback_finish: str | None) -> ChatCompletionChunk:
            text = "".join(buffered)
            calls = matcher.match(text)
            lp = None
            if calls:
                delta = ChatDelta(role="assistant", tool_calls=calls)
                reason = "tool_calls"
            else:
                if matcher.required:
                    raise RequestError(
                        "tool_choice requires a tool call but the model "
                        "produced none that matches"
                    )
                delta = ChatDelta(role="assistant", content=text)
                reason = fallback_finish
                if buffered_lp:
                    lp = self._chat_logprobs(buffered_lp)
            return ChatCompletionChunk(
                id=rid, model=oai.model,
                choices=[StreamChoice(delta=delta, logprobs=lp, finish_reason=reason)],
            )

        completion_tokens = 0
        finish = None
        first = True
        async for raw in downstream.generate(request.map(pre.to_wire())):
            out = EngineOutput.from_wire(raw) if isinstance(raw, dict) else raw
            completion_tokens += len(out.token_ids)
            finish = out.finish_reason.value if out.finish_reason else None
            if completion_tokens == 0 and not out.token_ids:
                # Shed or expired before any output: a typed error (HTTP
                # 429/503/504), not an empty 200.
                if out.finish_reason is FinishReason.SHED:
                    raise ShedError("request shed under overload before execution")
                if out.finish_reason is FinishReason.DEADLINE:
                    raise DeadlineError("request deadline expired before any output")
            if matcher is not None:
                if out.text:
                    buffered.append(out.text)
                if out.logprobs:
                    buffered_lp.extend(out.logprobs)
                lead = "".join(buffered).lstrip()
                if (
                    not matcher.required
                    and finish is None
                    and lead
                    and lead[0] not in "{[`"
                ):
                    matcher = None
                    out.text = "".join(buffered)
                    buffered.clear()
                    if buffered_lp:
                        # Every entry held while buffering goes with the
                        # flushed text.
                        out.logprobs = list(buffered_lp)
                        buffered_lp.clear()
                else:
                    if finish is None:
                        continue
                    yield tool_chunk(finish)
                    break
            delta = ChatDelta(
                role="assistant" if first else None, content=out.text
            )
            first = False
            if is_chat:
                lp = self._chat_logprobs(out.logprobs) if out.logprobs else None
                yield ChatCompletionChunk(
                    id=rid, model=oai.model,
                    choices=[StreamChoice(delta=delta, logprobs=lp,
                                          finish_reason=finish)],
                )
            else:
                lp = None
                if out.logprobs:
                    lp, text_offset = self._completion_logprobs(
                        out.logprobs, text_offset
                    )
                yield {
                    "id": rid,
                    "object": "text_completion",
                    "model": oai.model,
                    "choices": [
                        {
                            "index": 0,
                            "text": out.text or "",
                            "logprobs": lp,
                            "finish_reason": finish,
                        }
                    ],
                }
            if finish is not None:
                break

        if matcher is not None and buffered and finish is None:
            # Stream ended without a finish marker: flush the buffer.
            yield tool_chunk("stop")

        usage = Usage(
            prompt_tokens=prompt_tokens,
            completion_tokens=completion_tokens,
            total_tokens=prompt_tokens + completion_tokens,
        )
        if is_chat:
            yield ChatCompletionChunk(
                id=rid, model=oai.model, choices=[], usage=usage
            )
        else:
            yield {
                "id": rid,
                "object": "text_completion",
                "model": oai.model,
                "choices": [],
                "usage": usage.model_dump(),
            }
