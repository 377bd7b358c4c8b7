"""The port's OpenAI HTTP service (dynamo_tpu_torch/llm/http_service.py)
and its ``run`` CLI against the JAX package's, on the CPU.

Both servers listen on 127.0.0.1:0 in one event loop and are driven by
one standard-library client (dynamo_tpu_torch/llm/http_client.py): with
the echo engines (the JAX service set up as tests/test_http_service.py
does) every status code, JSON body (minus ``id``/``created``) and SSE
event must be equal; with tiny-test (the JAX engine, and the port's
engine on the CPU with the JAX weights carried across by
``params_from_jax``) four concurrent greedy requests must give
byte-identical text, usage and finish reasons. Also the HTTP/1.1
framing the port speaks itself, a client that disconnects mid-stream,
and the CLI serving and draining in a subprocess."""

import asyncio
import json
import os
import re
import signal
import socket
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.llm import admission as j_adm
from dynamo_tpu.llm.backend import Detokenizer as JDetokenizer
from dynamo_tpu.llm.discovery import ModelManager as JManager
from dynamo_tpu.llm.discovery import ModelWatcher, register_llm
from dynamo_tpu.llm.engines import EchoEngineCore as JEcho
from dynamo_tpu.llm.http_service import HttpService as JService
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor as JPre
from dynamo_tpu.llm.tokenizer import ToyTokenizer as JToy
from dynamo_tpu.models import llama as j_llama
from dynamo_tpu.models.config import ModelConfig as JCfg
from dynamo_tpu.runtime.distributed import DistributedRuntime
from dynamo_tpu.runtime.pipeline import Pipeline as JPipeline
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm import admission as t_adm
from dynamo_tpu_torch.llm.discovery import ModelManager, build_serving_pipeline
from dynamo_tpu_torch.llm.engines import EchoEngineCore
from dynamo_tpu_torch.llm.http_client import fetch
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.models import llama as t_llama
from dynamo_tpu_torch.models.config import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = "127.0.0.1"
MSG = [{"role": "user", "content": "hello tpu"}]


# -- harness ----------------------------------------------------------------
async def _jax_echo(admission=None):
    """The JAX service over EchoEngineCore, registered and discovered
    through an in-process runtime (tests/test_http_service.py:_setup)."""
    drt = await DistributedRuntime.in_process()
    ep = drt.namespace("dyn").component("tpu").endpoint("generate")
    await ep.serve(JEcho())
    await register_llm(drt, ep, JCard(name="echo-model", model_path="toy"))
    manager = JManager()
    await ModelWatcher(drt, manager).start()
    service = JService(manager, host=HOST, port=0, admission=admission)
    await service.start()

    async def close():
        await service.stop()
        await drt.shutdown()

    return service, close


async def _port_echo(admission=None):
    manager = ModelManager()
    card = ModelDeploymentCard(name="echo-model", model_path="toy")
    manager.add_model(card.name, build_serving_pipeline(card, EchoEngineCore()))
    service = HttpService(manager, host=HOST, port=0, admission=admission)
    await service.start()
    return service, service.stop


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _view(resp):
    """What must be equal between the servers: status, the JSON body or
    the SSE events (name and data) minus ids and timestamps."""
    ctype = resp.headers.get("content-type", "")
    if ctype.startswith("text/event-stream"):
        events = [(e.event, e.data if e.data == "[DONE]" else _strip(json.loads(e.data)))
                  for e in resp.events()]
        return resp.status, events
    if ctype.startswith("application/json"):
        return resp.status, _strip(resp.json())
    return resp.status, resp.body.decode()


def _both(scenario, admission=None):
    """Run ``scenario(port)`` against the JAX server, then the port's."""
    async def main():
        views = []
        for setup, mod in ((_jax_echo, j_adm), (_port_echo, t_adm)):
            service, close = await setup(admission(mod) if admission else None)
            try:
                views.append(await scenario(service))
            finally:
                await close()
        return views

    want, got = asyncio.run(main())
    assert got == want
    return got


# -- echo parity ------------------------------------------------------------
ECHO_REQUESTS = {
    "chat_stream": ("/v1/chat/completions", {"messages": MSG, "stream": True}),
    "chat_aggregate": ("/v1/chat/completions", {"messages": MSG}),
    "completion_stream": ("/v1/completions", {"prompt": "abc", "stream": True}),
    "completion_aggregate": ("/v1/completions", {"prompt": "abc"}),
    "completion_token_ids": ("/v1/completions", {"prompt": [104, 105], "max_tokens": 1}),
    "annotations_stream": ("/v1/chat/completions", {
        "messages": MSG, "stream": True,
        "nvext": {"annotations": ["formatted_prompt", "token_ids"]}}),
    "annotations_aggregate": ("/v1/chat/completions", {
        "messages": MSG, "nvext": {"annotations": ["token_ids"]}}),
    "stop_string": ("/v1/chat/completions", {"messages": MSG, "stop": "tpu"}),
    "unsupported_n": ("/v1/chat/completions", {"messages": MSG, "n": 2}),
    "unsupported_best_of": ("/v1/chat/completions", {"messages": MSG, "best_of": 4}),
    "unsupported_logit_bias": ("/v1/chat/completions", {
        "messages": MSG, "logit_bias": {"42": 5.0}}),
    "too_many_logprobs": ("/v1/chat/completions", {
        "messages": MSG, "logprobs": True, "top_logprobs": 99}),
    "unsupported_in_stream": ("/v1/chat/completions", {
        "messages": MSG, "n": 2, "stream": True}),
    "oversized_prompt": ("/v1/completions", {"prompt": "x" * 9000}),
    "batch_prompt": ("/v1/completions", {"prompt": ["a", "b"]}),
    "unknown_model": ("/v1/chat/completions", {"model": "nope", "messages": MSG}),
    "embeddings_unknown_model": ("/v1/embeddings", {"model": "nope", "input": "x"}),
}


@pytest.mark.parametrize("case", sorted(ECHO_REQUESTS))
def test_echo_requests_match_the_jax_server(case):
    path, body = ECHO_REQUESTS[case]

    async def scenario(service):
        resp = await fetch(HOST, service.port, "POST", path,
                           {"model": "echo-model", **body})
        return _view(resp)

    _both(scenario)


def test_invalid_bodies_get_the_same_statuses():
    async def scenario(service):
        out = []
        for body in (b"not json", b"", b"[1, 2]", json.dumps(
                {"model": "echo-model", "messages": "hi"}).encode()):
            reader, writer = await asyncio.open_connection(HOST, service.port)
            writer.write(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Connection: close\r\nContent-Length: %d\r\n\r\n%s"
                         % (len(body), body))
            raw = await reader.read()
            writer.close()
            head, _, payload = raw.partition(b"\r\n\r\n")
            err = json.loads(payload)["error"]
            # pydantic words its validation errors its own way: the
            # status, the type and the prefix are the contract.
            message = (err["message"] if body in (b"not json", b"")
                       else err["message"].split(":")[0])
            out.append((head.split()[1], err["type"], message))
        return out

    _both(scenario)


def test_get_routes_match():
    async def scenario(service):
        out = []
        for path in ("/v1/models", "/health", "/live", "/nope"):
            out.append(_view(await fetch(HOST, service.port, "GET", path)))
        resp = await fetch(HOST, service.port, "PUT", "/health")
        out.append((resp.status, resp.body))
        return out

    _both(scenario)


def test_body_over_one_mebibyte_is_refused_as_the_jax_server_does():
    async def scenario(service):
        body = {"model": "echo-model", "messages": [
            {"role": "user", "content": "a" * (1 << 20)}]}
        return _view(await fetch(HOST, service.port, "POST",
                                 "/v1/chat/completions", body))

    status, _ = _both(scenario)
    assert status == 400


def test_metric_names_match_after_the_same_traffic():
    async def scenario(service):
        for body in ({"messages": MSG}, {"messages": MSG, "n": 2},
                     {"messages": MSG, "stream": True}):
            await fetch(HOST, service.port, "POST", "/v1/chat/completions",
                        {"model": "echo-model", **body})
        text = (await fetch(HOST, service.port, "GET", "/metrics")).body.decode()
        names = {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                 if ln and not ln.startswith("#")}
        http = sorted(ln for ln in text.splitlines()
                      if ln.startswith("dyntpu_http_service_requests_total"))
        return names, http

    async def main():
        out = []
        for setup in (_jax_echo, _port_echo):
            service, close = await setup()
            try:
                out.append(await scenario(service))
            finally:
                await close()
        return out

    (j_names, j_http), (t_names, t_http) = asyncio.run(main())
    # The port exports a subset: no tracing, failover, retry, planner or
    # SLO-class planes yet.
    assert t_names <= j_names, sorted(t_names - j_names)
    assert t_http == j_http
    for name in ("dyntpu_http_service_request_duration_seconds_bucket",
                 "dyntpu_http_service_inflight_requests",
                 "dyntpu_http_service_shed_requests_total",
                 "dyntpu_http_service_draining",
                 "dyntpu_http_service_admission_inflight",
                 "dyntpu_http_service_admission_rejected_total"):
        assert name in t_names


def _delayed_echo(monkeypatch):
    monkeypatch.setenv("DYNTPU_TOKEN_ECHO_DELAY_MS", "20")


def test_past_max_inflight_is_429_with_retry_after(monkeypatch):
    _delayed_echo(monkeypatch)

    def admission(mod):
        return mod.AdmissionController(mod.AdmissionConfig(max_inflight=1))

    async def scenario(service):
        slow = asyncio.create_task(fetch(
            HOST, service.port, "POST", "/v1/chat/completions",
            {"model": "echo-model", "messages": MSG, "stream": True}))
        await asyncio.sleep(0.2)
        shed = await fetch(HOST, service.port, "POST", "/v1/chat/completions",
                           {"model": "echo-model", "messages": MSG})
        first = await slow
        return _view(shed), shed.headers["retry-after"], first.status

    _both(scenario, admission)


def test_draining_service_answers_503(monkeypatch):
    _delayed_echo(monkeypatch)

    async def scenario(service):
        inflight = asyncio.create_task(fetch(
            HOST, service.port, "POST", "/v1/completions",
            {"model": "echo-model", "prompt": "a long enough prompt", "stream": True}))
        await asyncio.sleep(0.1)
        drained = asyncio.create_task(service.drain(10.0))
        await asyncio.sleep(0.05)
        refused = await fetch(HOST, service.port, "POST", "/v1/chat/completions",
                              {"model": "echo-model", "messages": MSG})
        health = await fetch(HOST, service.port, "GET", "/health")
        done = await inflight
        return (_view(refused), refused.headers["retry-after"], _view(health),
                _view(done), await drained)

    _both(scenario)


# -- HTTP/1.1 framing of the port's server ----------------------------------
def _port_server(scenario):
    async def main():
        service, close = await _port_echo()
        try:
            return await scenario(service)
        finally:
            await close()

    return asyncio.run(main())


def test_keep_alive_carries_streams_and_bodies_on_one_connection():
    import http.client

    async def scenario(service):
        def client():
            conn = http.client.HTTPConnection(HOST, service.port, timeout=10)
            out = []
            for stream in (True, False, True):
                conn.request("POST", "/v1/completions", json.dumps(
                    {"model": "echo-model", "prompt": "abc", "stream": stream}),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                out.append((resp.status, resp.getheader("Transfer-Encoding"),
                            resp.read().decode().count("[DONE]")))
            sock = conn.sock
            conn.close()
            return out, sock is not None

        return await asyncio.to_thread(client)

    out, reused = _port_server(scenario)
    assert out == [(200, "chunked", 1), (200, None, 0), (200, "chunked", 1)]
    assert reused


async def _raw(port, data: bytes, read_until_close=True) -> bytes:
    reader, writer = await asyncio.open_connection(HOST, port)
    writer.write(data)
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 10)
    writer.close()
    return raw


def test_expect_100_continue_chunked_bodies_and_methods():
    body = json.dumps({"model": "echo-model", "prompt": "ab"}).encode()

    async def scenario(service):
        reader, writer = await asyncio.open_connection(HOST, service.port)
        writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Expect: 100-continue\r\nConnection: close\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body))
        await writer.drain()
        interim = await asyncio.wait_for(reader.readline(), 10)
        await reader.readline()
        writer.write(body)
        final = await asyncio.wait_for(reader.read(), 10)
        writer.close()
        chunked = await _raw(service.port, b"POST /v1/completions HTTP/1.1\r\n"
                             b"Host: x\r\nTransfer-Encoding: chunked\r\n\r\n"
                             b"2\r\n{}\r\n0\r\n\r\n")
        head = await _raw(service.port, b"HEAD /health HTTP/1.1\r\nHost: x\r\n"
                          b"Connection: close\r\n\r\n")
        bad = await _raw(service.port, b"nonsense\r\n\r\n")
        return interim, final, chunked, head, bad

    interim, final, chunked, head, bad = _port_server(scenario)
    assert interim == b"HTTP/1.1 100 Continue\r\n"
    assert final.startswith(b"HTTP/1.1 200 OK") and b'"text": "ab"' in final
    assert chunked.startswith(b"HTTP/1.1 411 ")
    assert bad.startswith(b"HTTP/1.1 400 ")

    # HEAD on a GET route answers as the JAX server's aiohttp web.get
    # does: the GET's status line, content type and length, no body.
    async def head_scenario(service):
        return _head_view(await _raw(
            service.port, b"HEAD /health HTTP/1.1\r\nHost: x\r\n"
            b"Connection: close\r\n\r\n"))

    # _both holds the port's answer equal to the JAX server's.
    port_head = _both(head_scenario)
    assert _head_view(head) == port_head
    assert port_head[0] == "HTTP/1.1 200 OK" and port_head[3] == b""


def _head_view(raw: bytes):
    """(status line, content type, content length, body) of a raw
    response read to the connection's close."""
    head, _, body = raw.partition(b"\r\n\r\n")
    status, *lines = head.decode("latin-1").split("\r\n")
    headers = dict(
        (k.strip().lower(), v.strip())
        for k, _, v in (line.partition(":") for line in lines)
    )
    return status, headers.get("content-type"), headers.get("content-length"), body


def test_unserved_headers_and_routes_are_refused():
    """The deadline and class headers are served (both answer 200, as
    the JAX server does), and so is /debug/routes now (the name is kept
    from when it was refused): both servers give the same route records,
    totals and router gauges for the same decisions, and the same 400
    for a bad ``n``. What stays refused is /v1/embeddings, 404 on both."""
    from dynamo_tpu.llm.kv_router.audit import ROUTE_OBS as J_OBS
    from dynamo_tpu.llm.kv_router.audit import RouteAuditRecord as JRec
    from dynamo_tpu_torch.llm.kv_router.audit import ROUTE_OBS as T_OBS
    from dynamo_tpu_torch.llm.kv_router.audit import RouteAuditRecord as TRec

    async def scenario(service):
        port_side = type(service).__module__.startswith("dynamo_tpu_torch")
        obs, rec = (T_OBS, TRec) if port_side else (J_OBS, JRec)
        out = []
        for headers in ({"X-Request-Timeout-Ms": "500"}, {"X-Request-Class": "batch"},
                        {"X-Request-Class": "interactive"}):
            resp = await fetch(HOST, service.port, "POST", "/v1/chat/completions",
                               {"model": "echo-model", "messages": MSG}, headers)
            out.append(resp.status)
        before = obs.routes_total, obs.predicted_blocks_total
        for i in range(3):
            obs.record(rec(request_id=f"r{i}", trace_id=f"t{i}", worker_id=7 + i,
                           overlap_blocks=i, isl_blocks=4, logit=0.25 * i,
                           decision_ms=1.5, unix=1000.0 + i,
                           candidates=[{"worker": 7 + i, "logit": 0.25 * i}],
                           indexer={"applied": 5, "pending": 0}))
        debug = await fetch(HOST, service.port, "GET", "/debug/routes?n=2")
        body = debug.json()
        out.append((debug.status, body["routes_total"] - before[0],
                    body["predicted_blocks_total"] - before[1], body["recent"],
                    {"kv_router_routes_total", "kv_router_predicted_blocks_total"}
                    <= set(body["gauges"])))
        bad = await fetch(HOST, service.port, "GET", "/debug/routes?n=zebra")
        out.append(_view(bad))
        metrics = (await fetch(HOST, service.port, "GET", "/metrics")).body.decode()
        out.append("kv_router_routes_total" in metrics)
        return out

    async def embeddings(service):
        return (await fetch(HOST, service.port, "POST", "/v1/embeddings",
                            {"model": "echo-model", "input": "x"})).status

    got = _both(scenario)
    assert got[:3] == [200, 200, 200] and got[3][:3] == (200, 3, 3)
    assert [r["trace"] for r in got[3][3]] == ["t1", "t2"] and got[3][4]
    assert got[4][0] == 400 and got[5] is True
    assert _port_server(embeddings) == 404


# -- tiny-test through both engines -----------------------------------------
JAX_CFG = JCfg.tiny_test()
ENGINE_KW = dict(
    dtype="float32", block_size=4, num_blocks=64, max_num_seqs=4,
    max_model_len=128, prefill_batch=2, unified_token_budget=32,
    unified_prefill_quantum=8,
)
TINY_REQUESTS = [
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "stream": True, "max_tokens": 8}),
    ("/v1/chat/completions", {"messages": [{"role": "system", "content": "be brief"},
                                           {"role": "user", "content": "why?"}],
                              "max_tokens": 6}),
    ("/v1/completions", {"prompt": "once upon a time", "stream": True, "max_tokens": 7}),
    ("/v1/completions", {"prompt": [7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9],
                         "max_tokens": 9}),
]


def _collect(resp):
    """(text, usage, finish_reason) of a streamed or aggregated reply."""
    if resp.headers.get("content-type", "").startswith("text/event-stream"):
        text, usage, finish = "", None, None
        for ev in resp.events():
            if ev.data == "[DONE]":
                continue
            chunk = json.loads(ev.data)
            for ch in chunk.get("choices", []):
                text += ch.get("text") or (ch.get("delta") or {}).get("content") or ""
                finish = ch.get("finish_reason") or finish
            usage = chunk.get("usage") or usage
        return text, usage, finish
    data = resp.json()
    ch = data["choices"][0]
    return ch.get("text", ch.get("message", {}).get("content")), data["usage"], \
        ch["finish_reason"]


@pytest.fixture(scope="module")
def tiny_servers():
    params = j_llama.init_params(jax.random.PRNGKey(0), JAX_CFG, dtype=jnp.float32)
    tparams = t_llama.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")

    async def main():
        jeng = TpuEngine(JEngineConfig(model=JAX_CFG, **ENGINE_KW), params=params)
        teng = TorchEngine(EngineConfig(model=ModelConfig.tiny_test(), **ENGINE_KW),
                           params=tparams, device="cpu")
        jcard = JCard(name="tiny-test", context_length=128)
        tcard = ModelDeploymentCard(name="tiny-test", context_length=128)
        jman, tman = JManager(), ModelManager()
        jman.add_model("tiny-test", JPipeline.link(
            JPre(jcard, JToy()), JDetokenizer(JToy()), engine=jeng), jcard)
        tman.add_model("tiny-test", build_serving_pipeline(tcard, teng))
        out = {}
        for name, eng, man, cls in (("jax", jeng, jman, JService),
                                    ("port", teng, tman, HttpService)):
            await eng.start()
            service = cls(man, host=HOST, port=0, readiness=eng.readiness)
            await service.start()
            try:
                replies = await asyncio.gather(*[
                    fetch(HOST, service.port, "POST", path, {
                        "model": "tiny-test", "temperature": 0,
                        "nvext": {"ignore_eos": True}, **body})
                    for path, body in TINY_REQUESTS])
                health = await fetch(HOST, service.port, "GET", "/health")
                out[name] = ([r.status for r in replies], [_collect(r) for r in replies],
                             health.json(), eng.readiness())
            finally:
                await service.stop()
                await eng.stop()
        return out

    return asyncio.run(main())


def test_tiny_test_replies_are_byte_identical(tiny_servers):
    j_status, j_replies, *_ = tiny_servers["jax"]
    t_status, t_replies, *_ = tiny_servers["port"]
    assert t_status == j_status == [200] * 4
    assert t_replies == j_replies
    assert [r[1]["completion_tokens"] for r in t_replies] == [8, 6, 7, 9]
    assert {r[2] for r in t_replies} == {"length"}


def test_tiny_test_readiness_uses_jax_names(tiny_servers):
    *_, j_health, j_ready = tiny_servers["jax"]
    *_, t_health, t_ready = tiny_servers["port"]
    assert set(t_ready) <= set(j_ready), sorted(set(t_ready) - set(j_ready))
    assert set(t_ready) == {
        "state", "draining", "shed_requests_total", "num_requests_waiting",
        "gpu_cache_usage_perc", "prefill_backlog_tokens", "gpu_prefix_cache_hit_rate",
        "unified_step_tokens_decode_total", "unified_step_tokens_prefill_total",
        # the compile lifecycle and speculative decoding
        "served_unwarmed", "warm_tail_pending", "mid_traffic_compiles_total",
        "compile_stall_ms_total", "warmed_programs", "warmup_programs_total",
        "spec_tokens_per_step", "spec_active", "spec_drafted_tokens_total",
        "spec_accepted_tokens_total",
        # SLO classes, deadlines, the tracer and the flight recorder
        "shed_interactive_total", "shed_batch_total", "deadline_exceeded_total",
        "abandoned_traces_total", "flight_steps_total", "num_waiting_interactive",
        "num_waiting_batch", "batch_fill_ratio",
        # the co-location controller
        "coloc_quantum", "itl_ema_ms", "itl_p95_ms", "itl_headroom_ms",
        "itl_slo_violations_total", "coloc_prefill_deferrals_total", "coloc_adaptive",
        # the KV observatory's actual reuse per tier, the engine heartbeat
        "kv_reused_device_blocks_total", "kv_reused_host_blocks_total",
        "kv_reused_disk_blocks_total", "kv_reused_peer_blocks_total",
        "last_dispatch_age_s",
        # disaggregation's degraded completions, the stored-KV precision
        "degraded_requests_total", "kvbm_kv_quant_ratio"}
    # Decode lanes issued depend on when requests arrived and how deep the
    # pipeline ran; the prompt tokens prefilled do not.
    for key in ("unified_step_tokens_prefill_total", "num_requests_waiting",
                "prefill_backlog_tokens", "state", "draining", "served_unwarmed",
                "warm_tail_pending", "warmed_programs", "spec_active",
                "num_waiting_interactive", "num_waiting_batch", "coloc_quantum",
                "coloc_adaptive", "itl_slo_violations_total",
                "coloc_prefill_deferrals_total"):
        assert t_ready[key] == j_ready[key], key
    assert t_ready["unified_step_tokens_decode_total"] >= sum([8, 6, 7, 9]) - 4
    assert t_health["status"] == j_health["status"] == "healthy"


def _tiny_port_engine(**kw):
    cfg = EngineConfig(model=ModelConfig.tiny_test(), **{**ENGINE_KW, **kw})
    return TorchEngine(cfg, device="cpu")


@pytest.mark.parametrize("how", ["reset", "close"])
def test_disconnect_mid_stream_returns_every_kv_block(how):
    async def main():
        engine = _tiny_port_engine()
        await engine.start()
        manager = ModelManager()
        card = ModelDeploymentCard(name="tiny-test", context_length=128)
        manager.add_model(card.name, build_serving_pipeline(card, engine))
        service = HttpService(manager, host=HOST, port=0, readiness=engine.readiness)
        await service.start()
        try:
            free = engine.allocator.num_free
            body = json.dumps({"model": "tiny-test", "prompt": list(range(1, 60)),
                               "max_tokens": 60, "stream": True,
                               "nvext": {"ignore_eos": True}}).encode()
            reader, writer = await asyncio.open_connection(HOST, service.port)
            writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            await writer.drain()
            seen = b""
            while seen.count(b"data: ") < 3:
                seen += await asyncio.wait_for(reader.read(256), 30)
            held = engine.allocator.num_free
            # The client goes away mid-stream: a reset, or an orderly close.
            writer.transport.abort() if how == "reset" else writer.close()
            for _ in range(500):
                if (not engine.scheduler.running and engine.allocator.num_free == free
                        and service.admission.inflight == 0):
                    break
                await asyncio.sleep(0.01)
            return free, held, engine.allocator.num_free, dict(engine.scheduler.running), \
                service.admission.inflight, engine.unified_decode_tokens
        finally:
            await service.stop()
            await engine.stop()

    free, held, after, running, inflight, decoded = asyncio.run(main())
    assert held < free
    assert (after, running, inflight) == (free, {}, 0)
    assert decoded < 60


def test_draining_engine_refuses_new_requests_and_finishes_admitted_ones():
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, ShedError, StopConditions)
    from dynamo_tpu_torch.runtime.engine import Context

    async def main():
        engine = _tiny_port_engine()
        await engine.start()
        try:
            pre = PreprocessedRequest(
                token_ids=[1, 2, 3], sampling=SamplingOptions(temperature=0.0),
                stop=StopConditions(max_tokens=12, ignore_eos=True)).to_wire()
            stream = engine.generate(Context(pre))
            first = await stream.__anext__()
            engine.begin_drain()
            state = engine.readiness()["state"]
            with pytest.raises(ShedError) as exc:
                await engine.generate(Context(pre)).__anext__()
            rest = [o async for o in stream]
            drained = await engine.wait_drained(10.0)
            return first, rest, state, exc.value.draining, drained, engine.drained
        finally:
            await engine.stop()

    first, rest, state, draining, drained, done = asyncio.run(main())
    tokens = first["token_ids"] + [t for o in rest for t in o["token_ids"]]
    assert len(tokens) == 12 and rest[-1]["finish_reason"] == "length"
    assert state == "draining" and draining and drained and done


# -- the CLI in a subprocess ------------------------------------------------
async def _spawn(*argv, ready=r"OpenAI server on http://127\.0\.0\.1:(\d+)"):
    # One intra-op thread: the tiny model gains nothing from more, and the
    # server's OpenMP threads would otherwise spin against the other test
    # workers on shared cores, slowing each CPU dispatch about a
    # hundredfold (a drained stream then outlasts the drain grace).
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "dynamo_tpu_torch", "run", *argv,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
        env=env, cwd=REPO)
    lines = []
    while True:
        line = (await asyncio.wait_for(proc.stdout.readline(), 180)).decode()
        if not line:
            raise RuntimeError("CLI died before ready:\n" + "".join(lines))
        lines.append(line)
        m = re.search(ready, line)
        if m:
            return proc, int(m.group(1))


CLI_TINY = ("--out", "torch", "--device", "cpu", "--model-path", "preset:tiny-test",
            "--http-host", HOST, "--http-port", "0", "--max-model-len", "128",
            "--num-blocks", "64", "--max-num-seqs", "4")


def test_cli_http_serves_the_tiny_preset_and_drains_on_sigterm():
    async def main():
        proc, port = await _spawn("--in", "http", *CLI_TINY)
        try:
            models = (await fetch(HOST, port, "GET", "/v1/models")).json()
            chat = await fetch(HOST, port, "POST", "/v1/chat/completions", {
                "model": "tiny-test", "max_tokens": 4,
                "messages": [{"role": "user", "content": "hi"}]})
            chunks = []
            inflight = asyncio.create_task(fetch(
                HOST, port, "POST", "/v1/completions",
                {"model": "tiny-test", "prompt": "drain me", "max_tokens": 48,
                 "stream": True, "nvext": {"ignore_eos": True}},
                on_chunk=chunks.append))
            while not chunks:
                await asyncio.sleep(0.01)
            proc.send_signal(signal.SIGTERM)
            done = await inflight
            out = (await asyncio.wait_for(proc.stdout.read(), 60)).decode()
            code = await asyncio.wait_for(proc.wait(), 60)
            return models, chat, done, out, code
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()

    models, chat, done, out, code = asyncio.run(main())
    assert [m["id"] for m in models["data"]] == ["tiny-test"]
    assert chat.status == 200 and chat.json()["usage"]["completion_tokens"] > 0
    assert done.status == 200
    assert _collect(done)[1]["completion_tokens"] == 48
    assert "shutting down" in out and code == 0


def test_cli_refuses_the_card_it_does_not_have():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    async def main():
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "dynamo_tpu_torch", "run", "--in", "http",
            "--model-path", "preset:tiny-test", "--http-port", "0",
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
            env=env, cwd=REPO)
        out = (await asyncio.wait_for(proc.stdout.read(), 120)).decode()
        return await proc.wait(), out

    code, out = asyncio.run(main())
    assert code != 0 and "device='cpu'" in out and "OpenAI server" not in out


def test_free_port_is_picked_for_port_zero():
    async def scenario(service):
        with socket.create_connection((HOST, service.port), timeout=5):
            return service.port

    assert _port_server(scenario) > 0
