"""Detokenizer operator (port of dynamo_tpu/llm/backend.py).

Sits between the preprocessor and the engine: forwards the tokenized
request unchanged, and on the response path incrementally detokenizes
engine token deltas into text, enforcing the stop conditions the engine
cannot see — stop *strings* via jailing (hold back any emitted tail that
could be the prefix of a stop string until it either matches or cannot),
eos suppression, max_tokens.
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm.protocols.common import (
    EngineOutput,
    FinishReason,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context
from dynamo_tpu_torch.runtime.pipeline import Operator


class StopStringJail:
    """Holds back streamed text that might be the start of a stop string."""

    def __init__(self, stop: list[str]) -> None:
        self._stop = [s for s in stop if s]
        self._held = ""

    def push(self, text: str) -> tuple[str, bool]:
        """Feed new text; returns (emittable_text, stopped)."""
        if not self._stop:
            return text, False
        buf = self._held + text
        for s in self._stop:
            idx = buf.find(s)
            if idx != -1:
                self._held = ""
                return buf[:idx], True
        # Longest suffix of buf that is a proper prefix of any stop string.
        max_hold = 0
        for s in self._stop:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    max_hold = max(max_hold, k)
                    break
        if max_hold:
            self._held = buf[-max_hold:]
            return buf[:-max_hold], False
        self._held = ""
        return buf, False

    def flush(self) -> str:
        held, self._held = self._held, ""
        return held


class Detokenizer(Operator):
    def __init__(self, tokenizer: Tokenizer) -> None:
        self.tokenizer = tokenizer

    async def generate(
        self, request: Context, downstream: AsyncEngine
    ) -> AsyncIterator[Any]:
        payload = request.payload
        pre = (
            PreprocessedRequest.from_wire(payload)
            if isinstance(payload, dict)
            else payload
        )
        stop: StopConditions = pre.stop
        stop_ids = set(stop.stop_token_ids)
        decoder = self.tokenizer.decode_stream()
        jail = StopStringJail(stop.stop)

        generated = 0
        async for raw in downstream.generate(request.map(payload)):
            out = EngineOutput.from_wire(raw) if isinstance(raw, dict) else raw
            text_parts: list[str] = []
            finish: FinishReason | None = out.finish_reason
            stopped = False

            for tid in out.token_ids:
                generated += 1
                if tid in stop_ids and not stop.ignore_eos:
                    finish = FinishReason.STOP
                    stopped = True
                    break
                piece = decoder.step(tid)
                if piece:
                    emit, hit = jail.push(piece)
                    if emit:
                        text_parts.append(emit)
                    if hit:
                        finish = FinishReason.STOP
                        stopped = True
                        break
                if stop.max_tokens is not None and generated >= stop.max_tokens:
                    if finish is None:
                        finish = FinishReason.LENGTH
                    stopped = True
                    break

            # Preserve engine-supplied text when no tokens were decoded
            # (EchoEngineFull and other text-native engines).
            out.text = "".join(text_parts) if text_parts else out.text
            out.finish_reason = finish
            yield out.to_wire()
            if stopped or finish is not None:
                request.stop_generating()
                break
