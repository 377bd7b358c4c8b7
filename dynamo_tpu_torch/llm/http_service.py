"""OpenAI-compatible HTTP service (port of dynamo_tpu/llm/http_service.py).

Routes: POST /v1/chat/completions, POST /v1/completions, GET /v1/models,
GET /health, GET /live, GET /metrics, GET /debug/steps|trace|routes|profile —
SSE streaming with a usage-final chunk, aggregated responses,
per-request metrics, admission control and graceful drain, with the
reference's status codes and bodies.

The reference serves through aiohttp; this port speaks HTTP/1.1 itself on
``asyncio`` streams, standard library only:

- request bodies by ``Content-Length`` up to 1 MiB (aiohttp's
  ``client_max_size``; a larger body gets the reference's answer, a 400
  "Request Entity Too Large"); ``Expect: 100-continue`` is answered;
  chunked request bodies are refused with 411;
- keep-alive across requests (HTTP/1.1 unless ``Connection: close``),
  idle connections closed after 75 s;
- streamed responses in ``Transfer-Encoding: chunked``, one chunk per
  SSE event, ending in the zero chunk so that the connection can carry
  the next request;
- HEAD on a GET route answers as aiohttp's ``web.get`` does: the GET's
  status and headers (its ``Content-Length`` included), no body; any
  other method a route does not serve gets 405, an unknown path 404, both
  in aiohttp's plain-text form.

A client that goes away mid-request — its connection reaches EOF or is
lost, whether the handler is waiting for the next token or writing one —
cancels the handler: the request's context is killed and the engine
aborts the sequence and frees its blocks.

/health answers 503 "warming" until the engine has made its hot program
set (the CUDA graphs it captures before traffic), and /metrics carries
the capture gauges, the co-location controller's fields, the shed and
deadline counters (per SLO class) and the tracer's histograms under the
reference's names.

Deadlines and classes: ``X-Request-Timeout-Ms`` (else the admission
config's default) becomes the request's deadline, 504 when it expires
before any output; ``X-Request-Class`` (interactive | batch, else the
configured default) scales the admission watermarks and rides the wire
to the scheduler. Each request is traced: ``received``, the
``admission`` span, then the pipeline's own spans.

Debug surface: /debug/steps?n= (the engine's flight recorder),
/debug/trace?n= (the tracer's live snapshot), /debug/routes?n= (the last
route-audit records of any KV router in the process, with the router
gauges), /debug/profile?seconds= (a ``torch.profiler`` window; 503
unless a profile directory is configured, 409 while one runs). Both
/metrics renderings carry the router gauges (``ROUTE_OBS``) and the
planner's (``PLANNER_OBS``).

/v1/embeddings fans each input of a request out to the model's
embeddings pipeline (llm/embedding.py) and folds the vectors, as float
lists or base64 little-endian float32, with the prompt tokens as usage;
a model whose card is not an embeddings model answers 400.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import email.utils
import json
import logging
import struct
from urllib.parse import parse_qsl

from dynamo_tpu_torch.llm import slo
from dynamo_tpu_torch.llm.admission import AdmissionController, AdmissionRejected
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.kv_router.audit import ROUTE_OBS
from dynamo_tpu_torch.llm.metrics import Metrics
from dynamo_tpu_torch.llm.protocols.annotated import Annotated
from dynamo_tpu_torch.llm.protocols.common import (
    DeadlineError,
    FailoverExhausted,
    RequestError,
    ShedError,
    WorkerDiedError,
)
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatMessage,
    Choice,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    EmbeddingData,
    EmbeddingRequest,
    EmbeddingResponse,
    ModelInfo,
    ModelList,
    Usage,
)
from dynamo_tpu_torch.llm.protocols.sse import SseEvent
from dynamo_tpu_torch.planner.obs import PLANNER_OBS
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils import concurrency
from dynamo_tpu_torch.utils.deadline import OVERLOAD, Deadline, parse_timeout_ms
from dynamo_tpu_torch.utils.logging import request_scope
from dynamo_tpu_torch.utils.profiling import ProfileError, Profiler
from dynamo_tpu_torch.utils.tracing import tracer

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 1 << 20     # aiohttp's default client_max_size
MAX_LINE_BYTES = 8190        # aiohttp's max_line_size / max_field_size
MAX_HEADERS = 128
KEEPALIVE_S = 75.0           # aiohttp's keepalive_timeout

DEADLINE_HEADER = "x-request-timeout-ms"
REQUEST_CLASS_HEADER = slo.REQUEST_CLASS_HEADER.lower()

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict", 411: "Length Required",
    429: "Too Many Requests", 500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

#: The engine readiness fields /metrics exports as gauges.
_ENGINE_GAUGES = (
    "mid_traffic_compiles_total",
    "compile_stall_ms_total",
    "warm_tail_pending",
    "warmed_programs",
    "warmup_programs_total",
    "gpu_prefix_cache_hit_rate",
    "spec_tokens_per_step",
    "spec_active",
    "spec_drafted_tokens_total",
    "spec_accepted_tokens_total",
    "unified_step_tokens_decode_total",
    "unified_step_tokens_prefill_total",
    "batch_fill_ratio",
    "coloc_quantum",
    "itl_ema_ms",
    "itl_p95_ms",
    "itl_headroom_ms",
    "itl_slo_violations_total",
    "coloc_prefill_deferrals_total",
    "prefill_backlog_tokens",
    "abandoned_traces_total",
    "flight_steps_total",
    "num_waiting_interactive",
    "num_waiting_batch",
)


class _BadRequest(Exception):
    def __init__(self, status: int, text: str) -> None:
        super().__init__(text)
        self.status = status


class _Response:
    def __init__(self, status: int, body: bytes, content_type: str,
                 headers: dict[str, str] | None = None) -> None:
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


def _json_response(obj, status: int = 200, headers=None) -> _Response:
    return _Response(status, json.dumps(obj).encode(),
                     "application/json; charset=utf-8", headers)


def _text_response(status: int, text: str, headers=None) -> _Response:
    return _Response(status, text.encode(), "text/plain; charset=utf-8", headers)


def _error(status: int, message: str, kind: str = "invalid_request_error") -> _Response:
    return _json_response({"error": {"message": message, "type": kind}}, status)


def _shed_response(reason: str, retry_after_s: float, draining: bool) -> _Response:
    """Typed overload rejection: 429 at capacity, 503 while draining,
    both with ``Retry-After``."""
    return _json_response(
        {"error": {"message": f"request rejected: {reason}",
                   "type": "overloaded_error"}},
        status=503 if draining else 429,
        headers={"Retry-After": str(max(1, round(retry_after_s)))},
    )


def _head(status: int, headers: dict[str, str], keep_alive: bool) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
             f"Date: {email.utils.formatdate(usegmt=True)}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    if not keep_alive:
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class _Request:
    __slots__ = ("method", "path", "headers", "body", "query")

    def __init__(self, method: str, path: str, headers: dict[str, str],
                 body: bytes, query: dict[str, str] | None = None) -> None:
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body
        self.query = query or {}


class _StreamWriter:
    """A response sent in chunked transfer encoding."""

    def __init__(self, writer: asyncio.StreamWriter, keep_alive: bool) -> None:
        self._w = writer
        self._keep_alive = keep_alive

    async def prepare(self, status: int, headers: dict[str, str]) -> None:
        self._w.write(_head(
            status, {**headers, "Transfer-Encoding": "chunked"}, self._keep_alive
        ))
        await self._w.drain()

    async def write(self, data: bytes) -> None:
        self._w.write(b"%x\r\n%s\r\n" % (len(data), data))
        await self._w.drain()

    async def write_eof(self) -> None:
        self._w.write(b"0\r\n\r\n")
        await self._w.drain()


class _Connection(asyncio.StreamReaderProtocol):
    """A StreamReaderProtocol that also records when the peer went away
    (EOF or a lost connection), so that handlers can stop on it."""

    def __init__(self, service: "HttpService") -> None:
        self.gone = asyncio.Event()
        self._service = service
        super().__init__(
            asyncio.StreamReader(limit=MAX_LINE_BYTES + 2), self._connected
        )

    def _connected(self, reader, writer):
        return self._service._serve_connection(reader, writer, self.gone)

    def eof_received(self):
        self.gone.set()
        return super().eof_received()

    def connection_lost(self, exc):
        self.gone.set()
        super().connection_lost(exc)


class HttpService:
    _ROUTES = {
        "/v1/chat/completions": ("POST", "_chat"),
        "/v1/completions": ("POST", "_completions"),
        "/v1/embeddings": ("POST", "_embeddings"),
        "/v1/models": ("GET", "_models"),
        "/health": ("GET", "_health"),
        "/live": ("GET", "_live"),
        "/metrics": ("GET", "_metrics"),
        "/debug/steps": ("GET", "_debug_steps"),
        "/debug/trace": ("GET", "_debug_trace"),
        "/debug/routes": ("GET", "_debug_routes"),
        "/debug/profile": ("GET", "_debug_profile"),
    }

    def __init__(
        self,
        manager: ModelManager,
        host: str = "0.0.0.0",
        port: int = 8080,
        readiness=None,
        admission: AdmissionController | None = None,
        debug=None,
        profiler: Profiler | None = None,
    ) -> None:
        """``readiness``: zero-arg callable returning the serving engine's
        snapshot (TorchEngine.readiness) — /health turns 503 while the
        engine drains, /metrics exports its gauges, and the admission
        gate's watermarks read it. ``admission``: the overload gate; None
        builds one with the default inflight cap so that drain works.
        ``debug``: the local engine for /debug/steps (anything with
        ``debug_steps(n)``); ``profiler`` enables /debug/profile."""
        self.manager = manager
        self.metrics = Metrics()
        self._readiness = readiness
        self.admission = admission or AdmissionController(engine_stats=readiness)
        self._debug = debug
        self.profiler = profiler
        self.host = host
        self.port = port
        self._server: asyncio.Server | None = None
        self._connections: set[asyncio.Task] = set()

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        # Handlers run on this loop: bind it for the affinity checker (a
        # no-op unless DYNTPU_CHECK_THREADS=1).
        concurrency.bind_thread("loop")
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _Connection(self), self.host, self.port
        )
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logger.info("HTTP service on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        tasks = list(self._connections)
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def drain(self, grace_s: float = 30.0) -> bool:
        """Refuse new requests (503 + Retry-After, /health 503) and wait
        up to ``grace_s`` for admitted requests to finish. True when the
        last one finished in time."""
        self.admission.begin_drain()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + grace_s
        while loop.time() < deadline:
            if self.admission.inflight == 0:
                return True
            await asyncio.sleep(0.05)
        return self.admission.inflight == 0

    # -- HTTP/1.1 -----------------------------------------------------------
    async def _serve_connection(self, reader, writer, gone: asyncio.Event) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            while True:
                try:
                    req, keep_alive = await self._read_request(reader, writer)
                except _BadRequest as exc:
                    writer.write(_head(exc.status, {
                        "Content-Type": "text/plain; charset=utf-8",
                        "Content-Length": str(len(str(exc))),
                    }, False) + str(exc).encode())
                    await writer.drain()
                    return
                if req is None:
                    return
                keep_alive = await self._respond(req, writer, keep_alive, gone)
                if not keep_alive:
                    return
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError):
            pass
        except asyncio.CancelledError:
            pass
        finally:
            self._connections.discard(task)
            writer.close()

    async def _read_request(self, reader, writer):
        """(request, keep_alive), or (None, False) when the client closed
        the connection between requests."""
        try:
            line = await asyncio.wait_for(reader.readline(), KEEPALIVE_S)
            while line in (b"\r\n", b"\n"):
                line = await reader.readline()
            if not line:
                return None, False
            parts = line.decode("latin-1").rstrip("\r\n").split(" ")
            if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
                raise _BadRequest(400, "400: Bad Request")
            method, target, version = parts
            headers: dict[str, str] = {}
            for _ in range(MAX_HEADERS):
                raw = await reader.readline()
                if not raw:
                    return None, False
                if raw in (b"\r\n", b"\n"):
                    break
                name, sep, value = raw.decode("latin-1").partition(":")
                if not sep or not name or name != name.strip():
                    raise _BadRequest(400, "400: Bad Request")
                key = name.lower()
                value = value.strip()
                headers[key] = f"{headers[key]}, {value}" if key in headers else value
            else:
                raise _BadRequest(400, "400: Bad Request")
        except ValueError:   # a line over the reader's limit
            raise _BadRequest(400, "400: Line too long") from None
        tokens = {t.strip().lower() for t in headers.get("connection", "").split(",")}
        keep_alive = (
            "keep-alive" in tokens if version == "HTTP/1.0" else "close" not in tokens
        )
        if "transfer-encoding" in headers:
            raise _BadRequest(411, "411: Length Required")
        length = headers.get("content-length", "0")
        if not length.isdigit():
            raise _BadRequest(400, "400: Bad Request")
        length = int(length)
        path, _, qs = target.partition("?")
        query = dict(parse_qsl(qs))
        if length > MAX_BODY_BYTES:
            # The reference reads this as a failed JSON body: 400.
            return _Request(method, path, headers, b"", query), None
        if length and headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = await reader.readexactly(length) if length else b""
        return _Request(method, path, headers, body, query), keep_alive

    async def _respond(self, req: _Request, writer, keep_alive, gone) -> bool:
        """Run the request's handler until it finishes or the client goes
        away; returns whether the connection stays open."""
        if keep_alive is None:   # body over the limit, left unread
            resp = _error(400, "invalid request: Request Entity Too Large")
            await self._write(writer, resp, False)
            return False
        route = self._ROUTES.get(req.path)
        if route is None:
            await self._write(writer, _text_response(404, "404: Not Found"), keep_alive)
            return keep_alive
        method, name = route
        head = req.method == "HEAD" and method == "GET"
        if req.method != method and not head:
            # A HEAD response carries no body.
            text = "" if req.method == "HEAD" else "405: Method Not Allowed"
            resp = _text_response(405, text, {"Allow": method})
            await self._write(writer, resp, keep_alive)
            return keep_alive
        handler = asyncio.ensure_future(
            getattr(self, name)(req, _StreamWriter(writer, keep_alive))
        )
        watch = asyncio.ensure_future(gone.wait())
        try:
            await asyncio.wait({handler, watch}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            watch.cancel()
            if not handler.done():   # the client went away, or the service stops
                handler.cancel()
                with contextlib.suppress(asyncio.CancelledError, ConnectionError):
                    await handler
        if handler.cancelled():
            return False
        # dynalint: allow[DT001] the handler task is done (asyncio.wait returned it, not cancelled): result() returns at once
        resp = handler.result()
        if resp is not None:
            await self._write(writer, resp, keep_alive, head_only=head)
        return keep_alive

    @staticmethod
    async def _write(writer, resp: _Response, keep_alive: bool,
                     head_only: bool = False) -> None:
        headers = {"Content-Type": resp.content_type,
                   "Content-Length": str(len(resp.body)), **resp.headers}
        body = b"" if head_only else resp.body
        writer.write(_head(resp.status, headers, keep_alive) + body)
        await writer.drain()

    # -- handlers -----------------------------------------------------------
    def _engine_readiness(self) -> dict | None:
        if self._readiness is None:
            return None
        try:
            return self._readiness() or {}
        except Exception:  # noqa: BLE001 — health must never 500 on a probe
            logger.exception("readiness probe failed")
            return {}

    async def _health(self, _req, _w) -> _Response:
        info = {"status": "healthy", "models": self.manager.models()}
        if self.admission.draining:
            info["status"] = "draining"
            return _json_response(info, status=503)
        eng = self._engine_readiness()
        if eng is not None:
            info["engine"] = eng
            if eng.get("state") == "warming":
                # Readiness probes hold traffic until the hot program set
                # is captured: no request lands on an uncaptured program.
                info["status"] = "warming"
                return _json_response(info, status=503)
            if eng.get("state") == "draining":
                info["status"] = "draining"
                return _json_response(info, status=503)
        return _json_response(info)

    async def _live(self, _req, _w) -> _Response:
        return _json_response({"status": "live"})

    async def _metrics(self, _req, _w) -> _Response:
        eng = self._engine_readiness()
        if eng:
            self.metrics.set_gauge(
                "engine_ready", 1.0 if eng.get("state") == "ready" else 0.0
            )
            for key in _ENGINE_GAUGES:
                if key in eng:
                    self.metrics.set_gauge(key, float(eng[key]))
            # KV observatory: actual-reuse totals per tier.
            for key, val in eng.items():
                if key.startswith("kv_reused_") and isinstance(val, (int, float)):
                    self.metrics.set_gauge(key, float(val))
        # Router-plane gauges (route counts, indexer staleness, scrape
        # failures) of any KvRouter living in this process.
        for key, val in ROUTE_OBS.gauges().items():
            self.metrics.set_gauge(key, float(val))
        # Planner-plane gauges (scale decisions, pool sizes, the last
        # decision's age) of any planner living in this process.
        for key, val in PLANNER_OBS.gauges().items():
            self.metrics.set_gauge(key, float(val))
        # Process-wide overload counters: they export without an engine
        # too (a frontend-only process sheds and expires work).
        self.metrics.set_gauge("shed_requests_total", float(OVERLOAD.shed_total))
        self.metrics.set_gauge("deadline_exceeded_total", float(OVERLOAD.deadline_total))
        self.metrics.set_gauge(
            "shed_interactive_total", float(OVERLOAD.shed_class_total(slo.INTERACTIVE))
        )
        self.metrics.set_gauge("shed_batch_total", float(OVERLOAD.shed_class_total(slo.BATCH)))
        adm = self.admission.snapshot()
        self.metrics.set_gauge("draining", float(adm["draining"]))
        self.metrics.set_gauge("admission_inflight", float(adm["inflight"]))
        self.metrics.set_gauge(
            "admission_rejected_total", float(adm["rejected_total"])
        )
        for cls in slo.CLASSES:
            self.metrics.set_gauge(
                f"admission_inflight_{cls}", float(adm["inflight_by_class"].get(cls, 0))
            )
            self.metrics.set_gauge(
                f"admission_admitted_{cls}_total",
                float(adm["admitted_by_class"].get(cls, 0)),
            )
            self.metrics.set_gauge(
                f"admission_rejected_{cls}_total",
                float(adm["rejected_by_class"].get(cls, 0)),
            )
        for reason, hint in adm["retry_after_by_reason"].items():
            self.metrics.set_gauge(f"admission_retry_after_{reason}_s", float(hint))
        return _text_response(200, self.metrics.render() + tracer().render())

    async def _models(self, _req, _w) -> _Response:
        listing = ModelList(data=[ModelInfo(id=m) for m in self.manager.models()])
        return _json_response(listing.model_dump())

    # -- debug surface ------------------------------------------------------
    @staticmethod
    def _int_query(req, name: str, default: int) -> int | None:
        try:
            return int(req.query.get(name, default))
        except ValueError:
            return None

    async def _debug_steps(self, req, _w) -> _Response:
        """The last N step records of the local engine's flight recorder."""
        if self._debug is None:
            return _error(404, "no local engine attached", kind="debug_error")
        n = self._int_query(req, "n", 64)
        if n is None:
            return _error(400, "n must be an integer")
        return _json_response({"steps": self._debug.debug_steps(n)})

    async def _debug_trace(self, req, _w) -> _Response:
        """The tracer's live snapshot: histogram digest and the most
        recent completed traces."""
        n = self._int_query(req, "n", 32)
        if n is None:
            return _error(400, "n must be an integer")
        return _json_response(tracer().snapshot(n))

    async def _debug_routes(self, req, _w) -> _Response:
        """The last N route-audit records of any KvRouter in this process:
        each decision's full candidate field, plus the router gauges."""
        n = self._int_query(req, "n", 64)
        if n is None:
            return _error(400, "n must be an integer")
        return _json_response(ROUTE_OBS.snapshot(n))

    async def _debug_profile(self, req, _w) -> _Response:
        """A torch.profiler window of ?seconds=N while serving continues;
        requires a configured profile directory."""
        if self.profiler is None or not self.profiler.configured:
            return _error(
                503, "profiling not configured — set --profile-dir / "
                "DYNTPU_PROFILE_DIR", kind="profile_error",
            )
        try:
            seconds = float(req.query.get("seconds", 5.0))
        except ValueError:
            return _error(400, "seconds must be a number")
        try:
            result = await self.profiler.capture(seconds)
        except ProfileError as exc:
            return _error(409 if exc.busy else 503, str(exc), kind="profile_error")
        return _json_response(result)

    async def _embeddings(self, req, _w) -> _Response:
        """Each input fans out to its own request of the embeddings
        pipeline; the vectors fold into one response (reference:
        openai.rs:212)."""
        try:
            oai = EmbeddingRequest.model_validate(json.loads(req.body.decode()))
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request: {exc}")
        engine = self.manager.get(oai.model)
        if engine is None:
            return _error(404, f"model {oai.model!r} not found")
        card = self.manager.card(oai.model)
        if card is None or card.model_type != "embeddings":
            return _error(400, f"model {oai.model!r} is not an embeddings model")
        raw = oai.input
        if isinstance(raw, str) or (raw and isinstance(raw[0], int)):
            inputs = [raw]   # one string or one pre-tokenized input
        else:
            inputs = list(raw)
        if not inputs or any(not item for item in inputs):
            return _error(400, "input must be non-empty")
        # Admitted only after validation: no early return holds a permit.
        try:
            permit = self.admission.admit(request_class=slo.normalize_class(
                req.headers.get(REQUEST_CLASS_HEADER),
                self.admission.cfg.default_request_class))
        except AdmissionRejected as exc:
            return _shed_response(exc.reason, exc.retry_after_s, exc.draining)

        async def one(idx: int, item):
            ctx = Context({"token_ids": list(item)} if isinstance(item, list)
                          else {"input": item})
            try:
                async for out in engine.generate(ctx):
                    return idx, out
                raise RuntimeError("embedding engine returned no output")
            finally:
                # Embeddings never reach the chat path's finish: close any
                # trace a router opened for this Context.
                tracer().finish(ctx.id)

        with permit, self.metrics.guard(oai.model, "embeddings") as guard:
            try:
                results = await asyncio.gather(*(one(i, x) for i, x in enumerate(inputs)))
            except ValueError as exc:
                return _error(400, str(exc))
            except Exception as exc:  # noqa: BLE001
                logger.exception("embeddings failed")
                return _error(500, str(exc))
            guard.success()
        if oai.encoding_format == "base64":
            # The OpenAI contract: little-endian float32 bytes, base64.
            def enc(vec):
                return base64.b64encode(struct.pack(f"<{len(vec)}f", *vec)).decode()
        else:
            def enc(vec):
                return vec
        total = sum(out["prompt_tokens"] for _, out in results)
        resp = EmbeddingResponse(
            data=[EmbeddingData(index=i, embedding=enc(out["embedding"]))
                  for i, out in sorted(results, key=lambda r: r[0])],
            model=oai.model, usage=Usage(prompt_tokens=total, total_tokens=total))
        return _json_response(resp.model_dump())

    async def _chat(self, req, w) -> _Response | None:
        return await self._serve(req, w, ChatCompletionRequest, "chat_completions")

    async def _completions(self, req, w) -> _Response | None:
        return await self._serve(req, w, CompletionRequest, "completions")

    def _request_deadline(self, req: _Request) -> Deadline | None:
        """The client's header budget, else the configured default, else
        none."""
        ms = parse_timeout_ms(req.headers.get(DEADLINE_HEADER))
        if ms is not None:
            return Deadline.after_ms(ms)
        default_s = self.admission.cfg.default_deadline_s
        return Deadline.after(default_s) if default_s > 0 else None

    async def _serve(self, req, w, request_type, endpoint: str) -> _Response | None:
        try:
            oai = request_type.model_validate(json.loads(req.body.decode()))
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request: {exc}")

        engine = self.manager.get(oai.model)
        if engine is None:
            return _error(404, f"model {oai.model!r} not found")

        ctx = Context(oai)
        tracer().mark(ctx.id, "received")
        # The class scales the watermarks and rides the Context onto the
        # wire, so every later shed/preempt decision knows it.
        request_class = slo.normalize_class(
            req.headers.get(REQUEST_CLASS_HEADER),
            self.admission.cfg.default_request_class,
        )
        ctx.annotations[slo.ANNOTATION_KEY] = request_class
        try:
            with tracer().span(ctx.id, "admission"):
                permit = self.admission.admit(request_class=request_class)
        except AdmissionRejected as exc:
            # Refused before any work: a deliberate drop, not an orphan.
            tracer().abandon(ctx.id)
            return _shed_response(exc.reason, exc.retry_after_s, exc.draining)
        deadline = self._request_deadline(req)
        if deadline is not None:
            ctx.annotations["deadline"] = deadline
        with request_scope(ctx.id, tracer().trace_id(ctx.id)), permit, \
                self.metrics.guard(oai.model, endpoint) as guard:
            try:
                if oai.stream:
                    return await self._stream(w, engine, ctx, guard)
                return await self._aggregate(engine, ctx, oai, guard)
            except asyncio.CancelledError:
                ctx.kill()
                raise
            except RequestError as exc:
                return _error(400, str(exc))
            except ShedError as exc:
                return _shed_response(str(exc), exc.retry_after_s, exc.draining)
            except DeadlineError as exc:
                return _error(504, str(exc), kind="deadline_exceeded")
            except (WorkerDiedError, FailoverExhausted) as exc:
                # The serving worker died and failover could not complete
                # the request elsewhere: a typed 502, never a 500.
                return _error(502, str(exc), kind="worker_died")
            except Exception as exc:  # noqa: BLE001
                logger.exception("%s failed", endpoint)
                return _error(500, str(exc))
            finally:
                # Idempotent: the engine usually finished it already; this
                # folds in requests that failed before reaching it.
                tracer().finish(ctx.id)

    async def _stream(self, w: _StreamWriter, engine, ctx: Context, guard) -> None:
        await w.prepare(200, {"Content-Type": "text/event-stream",
                              "Cache-Control": "no-cache"})
        stream = engine.generate(ctx)
        try:
            async for chunk in stream:
                if isinstance(chunk, Annotated):
                    await w.write(chunk.to_sse().encode())
                    continue
                obj = (
                    chunk.model_dump(exclude_none=True)
                    if hasattr(chunk, "model_dump")
                    else chunk
                )
                await w.write(SseEvent.data_json(obj).encode())
            await w.write(SseEvent.done().encode())
            guard.success()
        except (WorkerDiedError, FailoverExhausted) as exc:
            # A worker death the failover plane could not absorb (a
            # ConnectionError, but not the client's): reported in-band.
            await self._stream_error(w, exc, "worker_died")
        except (ConnectionError, asyncio.CancelledError):
            ctx.kill()
            await stream.aclose()
            raise
        except Exception as exc:  # noqa: BLE001 — headers are out: report in-band
            # A request failure after the SSE headers went out (a shed, a
            # refused parameter, tool_choice="required" with no call, an
            # engine fault): a terminal typed error event, then [DONE].
            if isinstance(exc, ShedError):
                kind = "overloaded_error"
            elif isinstance(exc, RequestError):
                kind = "invalid_request_error"
            elif isinstance(exc, DeadlineError):
                kind = "deadline_exceeded"
            else:
                logger.exception("stream failed")
                kind = "internal_error"
            await self._stream_error(w, exc, kind)
        await w.write_eof()
        return None

    @staticmethod
    async def _stream_error(w: _StreamWriter, exc: Exception, kind: str) -> None:
        await w.write(SseEvent.data_json(
            {"error": {"message": str(exc), "type": kind}}
        ).encode())
        await w.write(SseEvent.done().encode())

    async def _aggregate(self, engine, ctx: Context, oai, guard) -> _Response:
        """Fold the stream into one response."""
        text_parts: list[str] = []
        tool_calls: list[dict] = []
        lp_content: list[dict] = []      # chat logprob entries
        lp_lists: dict[str, list] = {}   # completions parallel lists
        finish = None
        usage = Usage()
        rid = None
        is_chat = isinstance(oai, ChatCompletionRequest)
        async for chunk in engine.generate(ctx):
            if isinstance(chunk, Annotated):
                continue
            if isinstance(chunk, ChatCompletionChunk):
                rid = chunk.id
                for choice in chunk.choices:
                    if choice.delta.content:
                        text_parts.append(choice.delta.content)
                    if choice.delta.tool_calls:
                        tool_calls.extend(choice.delta.tool_calls)
                    if choice.logprobs and choice.logprobs.get("content"):
                        lp_content.extend(choice.logprobs["content"])
                    if choice.finish_reason:
                        finish = choice.finish_reason
                if chunk.usage:
                    usage = chunk.usage
            elif isinstance(chunk, dict):
                rid = chunk.get("id", rid)
                for choice in chunk.get("choices", []):
                    if choice.get("text"):
                        text_parts.append(choice["text"])
                    if choice.get("logprobs"):
                        for k, v in choice["logprobs"].items():
                            lp_lists.setdefault(k, []).extend(v)
                    if choice.get("finish_reason"):
                        finish = choice["finish_reason"]
                if chunk.get("usage"):
                    usage = Usage.model_validate(chunk["usage"])
        guard.success()
        text = "".join(text_parts)
        if is_chat:
            full = ChatCompletionResponse(
                id=rid or "chatcmpl-0",
                model=oai.model,
                choices=[
                    Choice(
                        message=ChatMessage(
                            role="assistant",
                            # Tool-call turns carry null content, not "".
                            content=text if (text or not tool_calls) else None,
                            tool_calls=tool_calls or None,
                        ),
                        logprobs={"content": lp_content} if lp_content else None,
                        finish_reason=finish,
                    )
                ],
                usage=usage,
            )
        else:
            full = CompletionResponse(
                id=rid or "cmpl-0",
                model=oai.model,
                choices=[CompletionChoice(text=text, logprobs=lp_lists or None,
                                          finish_reason=finish)],
                usage=usage,
            )
        return _json_response(full.model_dump())


class HealthServer(HttpService):
    """The worker's health, metrics and debug endpoint (``--health-port``):
    no OpenAI surface. ``/health`` answers 503 while the engine warms or
    drains (the readiness probe's target); ``/metrics`` exports every
    numeric field of the engine's readiness snapshot, the process-wide
    shed/deadline/fault/retry/failover counters, ``gauges()`` (the served
    endpoint's request count) and the tracer's histograms, under the
    prefix ``dyntpu_worker``; ``/debug/*`` as on the OpenAI server."""

    _ROUTES = {
        "/health": ("GET", "_health"),
        "/live": ("GET", "_live"),
        "/metrics": ("GET", "_metrics"),
        "/debug/steps": ("GET", "_debug_steps"),
        "/debug/trace": ("GET", "_debug_trace"),
        "/debug/routes": ("GET", "_debug_routes"),
        "/debug/profile": ("GET", "_debug_profile"),
    }

    def __init__(self, readiness, host: str = "0.0.0.0", port: int = 8081,
                 gauges=None, debug=None, profiler: Profiler | None = None) -> None:
        super().__init__(ModelManager(), host=host, port=port, readiness=readiness,
                         debug=debug, profiler=profiler)
        self.metrics = Metrics(prefix="dyntpu_worker")
        self._gauges = gauges

    async def _health(self, _req, _w) -> _Response:
        eng = self._engine_readiness() or {}
        state = eng.get("state", "ready")
        if state in ("warming", "draining"):
            return _json_response({"status": state, "engine": eng}, status=503)
        return _json_response({"status": "healthy", "engine": eng})

    async def _metrics(self, _req, _w) -> _Response:
        from dynamo_tpu_torch.runtime.failover import FAILOVER
        from dynamo_tpu_torch.utils.faults import FAULTS
        from dynamo_tpu_torch.utils.retry import RETRIES

        eng = self._engine_readiness() or {}
        values = {k: v for k, v in eng.items() if isinstance(v, (int, float))}
        values.update({
            "engine_ready": eng.get("state") == "ready",
            "shed_requests_total": OVERLOAD.shed_total,
            "shed_interactive_total": OVERLOAD.shed_class_total(slo.INTERACTIVE),
            "shed_batch_total": OVERLOAD.shed_class_total(slo.BATCH),
            "deadline_exceeded_total": OVERLOAD.deadline_total,
            "faults_injected_total": FAULTS.total_injected,
            "retries_total": RETRIES.total,
            "failover_total": FAILOVER.total,
            "failover_success_total": FAILOVER.success_total,
            "workers_marked_dead_total": FAILOVER.marked_dead_total,
        })
        if self._gauges is not None:
            values.update(self._gauges())
        # A RouterService process fronts its KvRouter with a HealthServer:
        # the router gauges live there.
        values.update(ROUTE_OBS.gauges())
        # So do a planner's, where one hosts a health server.
        values.update(PLANNER_OBS.gauges())
        for key, val in values.items():
            self.metrics.set_gauge(key, float(val))
        # The worker is where the engine's span and ITL histograms
        # accumulate in a fleet: they export here.
        return _text_response(200, self.metrics.render() + tracer().render())
