"""Multimodal serving: the encode worker and the image-aware preprocessor
(port of dynamo_tpu/llm/multimodal.py).

- ``VisionEncodeEngine``: an AsyncEngine serving ``encode``: an image
  payload → the ViT forward (models/vision.py) → patch embeddings in the
  language model's hidden space, returned as raw float32 bytes.
- ``MultimodalPreprocessor``: the OpenAI preprocessor for chat messages
  that carry ``image_url`` content parts. Each image is encoded over the
  request plane (encode workers scale apart from the engines), its
  marker's token run in the prompt becomes a run of placeholder tokens,
  one per patch, and the request's ``mm_segments`` carry the embeddings
  the engine splices in place of those tokens (engine ``_mm_for_chunk``,
  models/llama.py ``embeds``).

Image sources (no network): ``data:`` URLs of a base64 ``.npy`` array
([H, W, 3] or [H, W], float or uint8). The reference also decodes image
files through PIL where it imports; the port imports no package beyond
torch and numpy, so it refuses them.
Images are resized to the encoder's square input by nearest neighbour.
"""

from __future__ import annotations

import asyncio
import base64
import io
from typing import Any, AsyncIterator

import numpy as np
import torch

from dynamo_tpu_torch import resolve_device
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest, RequestError
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.models.vision import VisionConfig, encode_image, init_vision_params
from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context


def decode_image(url_or_bytes: str | bytes, image_size: int) -> np.ndarray:
    """Image source → [image_size, image_size, 3] float32 in [0, 1]."""
    if isinstance(url_or_bytes, str):
        if not url_or_bytes.startswith("data:"):
            raise RequestError(
                "only data: URLs are supported (no network); got "
                f"{url_or_bytes[:32]!r}..."
            )
        raw = base64.b64decode(url_or_bytes.split(",", 1)[1])
    else:
        raw = url_or_bytes
    if raw[:6] != b"\x93NUMPY":
        raise RequestError("only .npy image payloads are decoded (no image-file decoder)")
    arr = np.asarray(np.load(io.BytesIO(raw), allow_pickle=False), np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.max() > 1.0:
        arr = arr / 255.0
    # Nearest-neighbour resize to the encoder's square input.
    h, w = arr.shape[:2]
    ys = (np.arange(image_size) * h) // image_size
    xs = (np.arange(image_size) * w) // image_size
    return np.ascontiguousarray(arr[ys][:, xs, :3], np.float32)


class VisionEncodeEngine:
    """Encode worker engine: ``{"image": <data URL | bytes>}`` → one
    response ``{"embeds": bytes, "shape": [n, out_dim], "dtype":
    "float32"}``.

    Construction does device work (the weights, one warm forward): build
    it off the event loop in a process that holds a runtime lease. Each
    forward runs off the loop (``asyncio.to_thread``) on a CUDA stream of
    its own, so its read-back waits for no engine dispatch."""

    def __init__(
        self,
        cfg: VisionConfig,
        params=None,
        rng_seed: int = 0,
        warmup: bool = True,
        device: str | torch.device | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(rng_seed)
            params = init_vision_params(g, cfg, dtype=dtype, device=self.device)
        self.params = params
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # The weights were written on the current stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self.images = 0
        if warmup:
            self.encode(np.zeros((cfg.image_size, cfg.image_size, 3), np.float32))

    def encode(self, image: np.ndarray) -> np.ndarray:
        """One image → [num_patches, out_dim] float32 on the host."""
        if self._stream is None:
            return encode_image(self.params, self.cfg, image).numpy()
        with torch.cuda.stream(self._stream):
            return encode_image(self.params, self.cfg, image).cpu().numpy()

    async def generate(self, request: Context) -> AsyncIterator[dict]:
        image = decode_image(request.payload["image"], self.cfg.image_size)
        embeds = await asyncio.to_thread(self.encode, image)
        self.images += 1
        yield {"embeds": embeds.tobytes(), "shape": list(embeds.shape), "dtype": "float32"}


class MultimodalPreprocessor(OpenAIPreprocessor):
    """OpenAI preprocessor that routes image content parts through the
    encode worker and splices placeholder-token runs into the prompt."""

    def __init__(
        self,
        card: ModelDeploymentCard,
        tokenizer: Tokenizer,
        encoder: AsyncEngine,
        placeholder_token: int = 0,
        image_marker: str = "<image>",
    ) -> None:
        super().__init__(card, tokenizer)
        self._encoder = encoder
        self._placeholder = placeholder_token
        self._marker = image_marker

    async def preprocess_async(
        self, request: ChatCompletionRequest | CompletionRequest
    ) -> PreprocessedRequest:
        images = (self._extract_images(request)
                  if isinstance(request, ChatCompletionRequest) else [])
        pre = self.preprocess(request)
        if not images:
            return pre
        return await self._splice(pre, images)

    def _extract_images(self, request: ChatCompletionRequest) -> list[Any]:
        """Collect the image sources; each becomes one marker in its
        message's text (the chat template renders text parts only)."""
        images: list[Any] = []
        for msg in request.messages:
            if not isinstance(msg.content, list):
                continue
            parts_text: list[str] = []
            for part in msg.content:
                if not isinstance(part, dict):
                    continue
                if part.get("type") == "text":
                    parts_text.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = (part.get("image_url") or {}).get("url")
                    if url:
                        images.append(url)
                        parts_text.append(self._marker)
            msg.content = "".join(parts_text)
        return images

    async def _splice(self, pre: PreprocessedRequest, images: list[Any]) -> PreprocessedRequest:
        token_ids = list(pre.token_ids)
        needle = self._find_needle(token_ids, self.tokenizer.encode(self._marker))
        # A literal marker typed by the user is indistinguishable from an
        # injected one at the token level: splicing at the wrong spot would
        # bind images to the wrong positions, so refuse.
        count = _count_sub(token_ids, needle)
        if count != len(images):
            raise RequestError(
                f"prompt contains {count} {self._marker!r} marker run(s) for "
                f"{len(images)} image(s); remove literal markers from text content"
            )
        segments: list[dict[str, Any]] = []
        for image in images:
            idx = _find_sub(token_ids, needle)
            out = None
            async for item in self._encoder.generate(Context({"image": image})):
                out = item
                break
            if out is None:
                raise RuntimeError("encode worker returned no embeddings")
            n = out["shape"][0]
            token_ids[idx:idx + len(needle)] = [self._placeholder] * n
            segments.append({"offset": idx, "data": out["embeds"], "shape": out["shape"],
                             "dtype": out.get("dtype", "float32")})
        # The splice changed the prompt's length: redo the context budget
        # on the spliced prompt, so an oversized one fails here as a
        # client error, not in the scheduler.
        budget = self.card.context_length - len(token_ids)
        if budget <= 0:
            raise RequestError(
                f"prompt ({len(token_ids)} tokens after image expansion) "
                f"exceeds context length {self.card.context_length}"
            )
        pre.stop.max_tokens = min(pre.stop.max_tokens or budget, budget)
        pre.token_ids = token_ids
        pre.mm_segments = segments
        return pre

    def _find_needle(self, token_ids: list[int], marker_ids: list[int]) -> list[int]:
        """The marker's token run in context: the raw encoding, then with
        its leading special tokens (BOS and the like) dropped one by one."""
        for skip in range(len(marker_ids)):
            needle = marker_ids[skip:]
            if needle and _find_sub(token_ids, needle) >= 0:
                return needle
        raise RequestError("image marker not found in the tokenized prompt")


def _find_sub(haystack: list[int], needle: list[int]) -> int:
    n = len(needle)
    for i in range(len(haystack) - n + 1):
        if haystack[i:i + n] == needle:
            return i
    return -1


def _count_sub(haystack: list[int], needle: list[int]) -> int:
    count, i, n = 0, 0, len(needle)
    while (j := _find_sub(haystack[i:], needle)) >= 0:
        count += 1
        i += j + n
    return count
