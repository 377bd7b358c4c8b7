"""Echo test engines (port of dynamo_tpu/llm/engines.py).

Deterministic fixture engines for exercising the full pipeline without a
model: EchoEngineCore echoes the prompt's token ids back one at a time,
EchoEngineFull echoes the formatted prompt's text. Rate via env
``DYNTPU_TOKEN_ECHO_DELAY_MS`` (default 0).
"""

from __future__ import annotations

import asyncio
import os
from typing import AsyncIterator

from dynamo_tpu_torch.llm.protocols.common import (
    EngineOutput,
    FinishReason,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.engine import Context


def _delay_s() -> float:
    return float(os.environ.get("DYNTPU_TOKEN_ECHO_DELAY_MS", "0")) / 1000.0


class EchoEngineCore:
    """Echoes prompt token ids back as generated tokens."""

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        pre = PreprocessedRequest.from_wire(request.payload)
        delay = _delay_s()
        max_tokens = pre.stop.max_tokens or len(pre.token_ids)
        count = 0
        for tid in pre.token_ids:
            if request.is_stopped or count >= max_tokens:
                break
            if delay:
                await asyncio.sleep(delay)
            count += 1
            yield EngineOutput(token_ids=[tid], cum_tokens=count).to_wire()
        yield EngineOutput(
            token_ids=[], finish_reason=FinishReason.STOP, cum_tokens=count
        ).to_wire()


class EchoEngineFull:
    """Echoes the formatted prompt TEXT back, bypassing detokenization:
    text-bearing EngineOutputs the Detokenizer passes through."""

    CHUNK = 8  # characters per emitted delta

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        pre = PreprocessedRequest.from_wire(request.payload)
        text = pre.annotations.get("formatted_prompt") or ""
        delay = _delay_s()
        count = 0
        for i in range(0, len(text), self.CHUNK):
            if request.is_stopped:
                break
            if delay:
                await asyncio.sleep(delay)
            count += 1
            out = EngineOutput(token_ids=[], cum_tokens=count)
            out.text = text[i : i + self.CHUNK]
            yield out.to_wire()
        yield EngineOutput(
            token_ids=[], finish_reason=FinishReason.STOP, cum_tokens=count
        ).to_wire()
