"""OpenAI-compatible HTTP service (port of dynamo_tpu/llm/http_service.py).

Routes: POST /v1/chat/completions, POST /v1/completions, GET /v1/models,
GET /health, GET /live, GET /metrics — SSE streaming with a usage-final
chunk, aggregated responses, per-request metrics, admission control and
graceful drain, with the reference's status codes and bodies.

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
the capture gauges under the reference's names.

Not in this port yet, refused rather than ignored: /v1/embeddings and
/debug/* (404 with the reference's error body), deadlines
(``X-Request-Timeout-Ms``) and SLO classes other than the default
(``X-Request-Class``), both a 400.
"""

from __future__ import annotations

import asyncio
import contextlib
import email.utils
import json
import logging

from dynamo_tpu_torch.llm.admission import AdmissionController, AdmissionRejected
from dynamo_tpu_torch.llm.discovery import ModelManager
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
    EmbeddingRequest,
    ModelInfo,
    ModelList,
    Usage,
)
from dynamo_tpu_torch.llm.protocols.sse import SseEvent
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.utils.overload import OVERLOAD

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 1 << 20     # aiohttp's default client_max_size
MAX_LINE_BYTES = 8190        # aiohttp's max_line_size / max_field_size
MAX_HEADERS = 128
KEEPALIVE_S = 75.0           # aiohttp's keepalive_timeout

DEADLINE_HEADER = "x-request-timeout-ms"
REQUEST_CLASS_HEADER = "x-request-class"
SERVED_REQUEST_CLASS = "interactive"

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 411: "Length Required", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


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
    __slots__ = ("method", "path", "headers", "body")

    def __init__(self, method: str, path: str, headers: dict[str, str],
                 body: bytes) -> None:
        self.method = method
        self.path = path
        self.headers = headers
        self.body = body


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
    }

    def __init__(
        self,
        manager: ModelManager,
        host: str = "0.0.0.0",
        port: int = 8080,
        readiness=None,
        admission: AdmissionController | None = None,
    ) -> None:
        """``readiness``: zero-arg callable returning the serving engine's
        snapshot (TorchEngine.readiness) — /health turns 503 while the
        engine drains, /metrics exports its gauges, and the admission
        gate's watermarks read it. ``admission``: the overload gate; None
        builds one with the default inflight cap so that drain works."""
        self.manager = manager
        self.metrics = Metrics()
        self._readiness = readiness
        self.admission = admission or AdmissionController(engine_stats=readiness)
        self.host = host
        self.port = port
        self._server: asyncio.Server | None = None
        self._connections: set[asyncio.Task] = set()

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
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
        path = target.split("?", 1)[0]
        if length > MAX_BODY_BYTES:
            # The reference reads this as a failed JSON body: 400.
            return _Request(method, path, headers, b""), None
        if length and headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = await reader.readexactly(length) if length else b""
        return _Request(method, path, headers, body), keep_alive

    async def _respond(self, req: _Request, writer, keep_alive, gone) -> bool:
        """Run the request's handler until it finishes or the client goes
        away; returns whether the connection stays open."""
        if keep_alive is None:   # body over the limit, left unread
            resp = _error(400, "invalid request: Request Entity Too Large")
            await self._write(writer, resp, False)
            return False
        route = self._ROUTES.get(req.path)
        if route is None and req.path.startswith("/debug/"):
            route = ("GET", "_debug")
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
            for key in (
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
                "prefill_backlog_tokens",
            ):
                if key in eng:
                    self.metrics.set_gauge(key, float(eng[key]))
        self.metrics.set_gauge("shed_requests_total", float(OVERLOAD.shed_total))
        adm = self.admission.snapshot()
        self.metrics.set_gauge("draining", float(adm["draining"]))
        self.metrics.set_gauge("admission_inflight", float(adm["inflight"]))
        self.metrics.set_gauge(
            "admission_rejected_total", float(adm["rejected_total"])
        )
        for reason, hint in adm["retry_after_by_reason"].items():
            self.metrics.set_gauge(f"admission_retry_after_{reason}_s", float(hint))
        return _text_response(200, self.metrics.render())

    async def _models(self, _req, _w) -> _Response:
        listing = ModelList(data=[ModelInfo(id=m) for m in self.manager.models()])
        return _json_response(listing.model_dump())

    async def _debug(self, req, _w) -> _Response:
        return _error(404, f"{req.path} is not served by this slice",
                      kind="debug_error")

    async def _embeddings(self, req, _w) -> _Response:
        try:
            oai = EmbeddingRequest.model_validate(json.loads(req.body.decode()))
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request: {exc}")
        if self.manager.get(oai.model) is None:
            return _error(404, f"model {oai.model!r} not found")
        return _error(
            404, f"model {oai.model!r} serves chat; embeddings are not "
            "served by this slice"
        )

    async def _chat(self, req, w) -> _Response | None:
        return await self._serve(req, w, ChatCompletionRequest, "chat_completions")

    async def _completions(self, req, w) -> _Response | None:
        return await self._serve(req, w, CompletionRequest, "completions")

    @staticmethod
    def _unserved_header(req: _Request) -> str | None:
        if DEADLINE_HEADER in req.headers:
            return "request deadlines (X-Request-Timeout-Ms) are not served yet"
        cls = req.headers.get(REQUEST_CLASS_HEADER)
        if cls is not None and cls.strip().lower() != SERVED_REQUEST_CLASS:
            return (f"request class {cls!r} is not served yet; only "
                    f"{SERVED_REQUEST_CLASS!r}")
        return None

    async def _serve(self, req, w, request_type, endpoint: str) -> _Response | None:
        try:
            oai = request_type.model_validate(json.loads(req.body.decode()))
        except Exception as exc:  # noqa: BLE001
            return _error(400, f"invalid request: {exc}")

        engine = self.manager.get(oai.model)
        if engine is None:
            return _error(404, f"model {oai.model!r} not found")
        unserved = self._unserved_header(req)
        if unserved:
            return _error(400, unserved)

        ctx = Context(oai)
        try:
            permit = self.admission.admit()
        except AdmissionRejected as exc:
            return _shed_response(exc.reason, exc.retry_after_s, exc.draining)
        with permit, self.metrics.guard(oai.model, endpoint) as guard:
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
    """The worker's health and metrics endpoint (``--health-port``): no
    OpenAI surface. ``/health`` answers 503 while the engine warms or
    drains (the readiness probe's target); ``/metrics`` exports every
    numeric field of the engine's readiness snapshot, the process-wide
    shed/fault/retry/failover counters and ``gauges()`` (the served
    endpoint's request count), under the prefix ``dyntpu_worker``."""

    _ROUTES = {
        "/health": ("GET", "_health"),
        "/live": ("GET", "_live"),
        "/metrics": ("GET", "_metrics"),
    }

    def __init__(self, readiness, host: str = "0.0.0.0", port: int = 8081,
                 gauges=None) -> None:
        super().__init__(ModelManager(), host=host, port=port, readiness=readiness)
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
            "faults_injected_total": FAULTS.total_injected,
            "retries_total": RETRIES.total,
            "failover_total": FAILOVER.total,
            "failover_success_total": FAILOVER.success_total,
            "workers_marked_dead_total": FAILOVER.marked_dead_total,
        })
        if self._gauges is not None:
            values.update(self._gauges())
        for key, val in values.items():
            self.metrics.set_gauge(key, float(val))
        return _text_response(200, self.metrics.render())
