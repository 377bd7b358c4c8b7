"""The port's serving front (dynamo_tpu_torch/llm, runtime/pipeline.py,
cli.py) against the JAX package's, in process on the CPU: the same
request bodies through both OpenAI validators, the same message lists
through both chat templates, the same requests through both
preprocessors, the same engine-output streams through both
detokenizers, the same load through both admission gates, the same
observations through both metric registries, and the same flags through
both CLIs."""

import asyncio
import json
import os
import subprocess
import sys

import pytest

from dynamo_tpu.llm import admission as j_adm
from dynamo_tpu.llm import backend as j_backend
from dynamo_tpu.llm import engines as j_engines
from dynamo_tpu.llm import metrics as j_metrics
from dynamo_tpu.llm import preprocessor as j_pre
from dynamo_tpu.llm import tools as j_tools
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JCard
from dynamo_tpu.llm.protocols import common as j_common
from dynamo_tpu.llm.protocols import openai as j_oai
from dynamo_tpu.llm.protocols import sse as j_sse
from dynamo_tpu.llm.tokenizer import ToyTokenizer as JToy
from dynamo_tpu.runtime.engine import Context as JContext
from dynamo_tpu.runtime.engine import EngineAdapter
from dynamo_tpu.runtime.pipeline import Pipeline as JPipeline
from dynamo_tpu_torch import cli as t_cli
from dynamo_tpu_torch.llm import admission as t_adm
from dynamo_tpu_torch.llm import backend as t_backend
from dynamo_tpu_torch.llm import engines as t_engines
from dynamo_tpu_torch.llm import metrics as t_metrics
from dynamo_tpu_torch.llm import preprocessor as t_pre
from dynamo_tpu_torch.llm import tools as t_tools
from dynamo_tpu_torch.llm.local_model import LocalModel
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as TCard
from dynamo_tpu_torch.llm.protocols import common as t_common
from dynamo_tpu_torch.llm.protocols import openai as t_oai
from dynamo_tpu_torch.llm.protocols import sse as t_sse
from dynamo_tpu_torch.llm.tokenizer import ToyTokenizer as TToy
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime.engine import Context as TContext
from dynamo_tpu_torch.runtime.pipeline import Pipeline as TPipeline
from dynamo_tpu_torch.runtime.pipeline import Segment, Tap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSG = [{"role": "user", "content": "x"}]


# -- protocol ---------------------------------------------------------------
CHAT_BODIES = {
    "minimal": {},
    "stream_string": {"stream": "true"},
    "stream_int_one": {"stream": 1},
    "stream_two": {"stream": 2},
    "stream_half": {"stream": 0.5},
    "max_tokens_integral_float": {"max_tokens": 5.0},
    "max_tokens_fraction": {"max_tokens": 5.5},
    "max_tokens_numeric_string": {"max_tokens": " 5_000 "},
    "max_tokens_string_zero_fraction": {"max_tokens": "5.000"},
    "max_tokens_bool": {"max_tokens": True},
    "max_tokens_list": {"max_tokens": [5]},
    "max_tokens_hex": {"max_tokens": "0x10"},
    "temperature_int": {"temperature": 1},
    "temperature_string": {"temperature": "0.5"},
    "temperature_inf_string": {"temperature": "inf"},
    "temperature_huge_int": {"temperature": 10**400},
    "stop_string": {"stop": "x"},
    "stop_list": {"stop": ["x", "y"]},
    "stop_mixed": {"stop": ["a", 1]},
    "logprobs_true": {"logprobs": True},
    "logprobs_string_zero": {"logprobs": "0"},
    "logprobs_float_one": {"logprobs": 1.0},
    "logprobs_float_two": {"logprobs": 2.0},
    "logit_bias": {"logit_bias": {"42": 5}},
    "logit_bias_bad": {"logit_bias": {"42": "x"}},
    "nvext_yes": {"nvext": {"ignore_eos": "yes", "foo": 1}},
    "ext_and_nvext": {"ext": {"greedy": True}, "nvext": {"ignore_eos": True}},
    "nvext_annotations_string": {"nvext": {"annotations": "token_ids"}},
    "nvext_int": {"nvext": 5},
    "extra_fields": {"foo": {"a": 1}, "user": "u"},
    "model_int": {"model": 5},
    "no_model": {"model": None},
    "content_int": {"messages": [{"role": "user", "content": 5}]},
    "content_parts": {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "a", "x": None}]}]},
    "messages_string": {"messages": "hi"},
    "message_extras": {"messages": [
        {"role": "tool", "content": "r", "tool_call_id": "c1", "name": None}]},
    "tools_bad": {"tools": ["x"]},
    "max_completion_tokens": {"max_completion_tokens": 7, "max_tokens": 3},
    "sampling": {"temperature": 0.7, "top_p": 0.9, "top_k": "40", "seed": -1,
                 "min_tokens": 2, "frequency_penalty": 0.0},
}
COMPLETION_BODIES = {
    "prompt_string": {"prompt": "hi"},
    "prompt_ids": {"prompt": [1, 2]},
    "prompt_strings": {"prompt": ["a", "b"]},
    "prompt_empty": {"prompt": []},
    "prompt_mixed": {"prompt": [1, "a"]},
    "prompt_floats": {"prompt": [1.0, 2.0]},
    "prompt_bools": {"prompt": [True, False]},
    "prompt_nested": {"prompt": [[1, 2], [3]]},
    "prompt_int": {"prompt": 5},
    "prompt_missing": {},
    "echo_string": {"prompt": "a", "echo": "no"},
    "logprobs_count": {"prompt": "a", "logprobs": "5"},
}


def _validated(mod, cls: str, body: dict):
    """(accepted, dumps, sampling wire, stop wire) — compared as JSON so
    that 1 and 1.0 differ."""
    try:
        req = getattr(mod, cls).model_validate(body)
    except ValueError:
        return ("rejected",)
    return json.dumps([req.model_dump(), req.model_dump(exclude_none=True),
                       req.sampling_options().to_wire(),
                       req.stop_conditions().to_wire()])


@pytest.mark.parametrize("case", sorted(CHAT_BODIES))
def test_chat_request_validation_matches_pydantic(case):
    body = {"model": "m", "messages": MSG, **CHAT_BODIES[case]}
    body = {k: v for k, v in body.items() if v is not None}
    want = _validated(j_oai, "ChatCompletionRequest", body)
    assert _validated(t_oai, "ChatCompletionRequest", body) == want


@pytest.mark.parametrize("case", sorted(COMPLETION_BODIES))
def test_completion_request_validation_matches_pydantic(case):
    body = {"model": "m", **COMPLETION_BODIES[case]}
    want = _validated(j_oai, "CompletionRequest", body)
    assert _validated(t_oai, "CompletionRequest", body) == want


def test_response_models_dump_as_the_reference_does():
    def build(m):
        return m.ChatCompletionChunk(
            id="c", created=1, model="m",
            choices=[m.StreamChoice(delta=m.ChatDelta(role="assistant",
                                                      content="hi"))],
            usage=m.Usage(prompt_tokens=1, completion_tokens=2,
                          total_tokens=3),
        )

    for exclude in (False, True):
        assert (build(t_oai).model_dump(exclude_none=exclude)
                == build(j_oai).model_dump(exclude_none=exclude))
    assert (t_oai.ModelList(data=[t_oai.ModelInfo(id="a", created=0)]).model_dump()
            == j_oai.ModelList(data=[j_oai.ModelInfo(id="a", created=0)]).model_dump())


def test_sse_codec_matches():
    for ev in ({"data": "a\nb", "event": "e", "id": "1", "comment": "c"},
               {"data": ""}, {"event": "only"}):
        assert t_sse.SseEvent(**ev).encode() == j_sse.SseEvent(**ev).encode()
    text = (j_sse.SseEvent.data_json({"x": 1}).encode()
            + j_sse.SseEvent.done().encode()).decode()
    assert ([vars(e) for e in t_sse.decode_stream(text)]
            == [vars(e) for e in j_sse.decode_stream(text)])


# -- chat template ----------------------------------------------------------
TEMPLATE_CASES = {
    "user": [{"role": "user", "content": "hi there"}],
    "conversation": [
        {"role": "system", "content": "You are terse."},
        {"role": "user", "content": "héllo wörld ✓\nline two"},
        {"role": "assistant", "content": "  spaced  "},
        {"role": "user", "content": "{% raw %}{{ not a tag }}"},
    ],
    "parts": [{"role": "user", "content": [
        {"type": "text", "text": "a"}, {"type": "image_url", "image_url": {"url": "u"}},
        {"type": "text", "text": "b", "extra": None}]}],
    "no_content": [{"role": "assistant", "tool_calls": [{"id": "t"}]}],
    "empty": [],
    "tool_turn": [{"role": "tool", "content": "42", "tool_call_id": "c1"}],
}


@pytest.mark.parametrize("agp", [True, False])
@pytest.mark.parametrize("case", sorted(TEMPLATE_CASES))
def test_default_chat_template_renders_byte_identical(case, agp):
    msgs = [j_oai.ChatMessage.model_validate(m).model_dump(exclude_none=True)
            for m in TEMPLATE_CASES[case]]
    want = JToy().apply_chat_template(msgs, add_generation_prompt=agp)
    got = TToy().apply_chat_template(msgs, add_generation_prompt=agp)
    assert got.encode() == want.encode()


def test_toy_tokenizer_matches():
    j, t = JToy(), TToy()
    text = "a✓b héllo"
    assert t.encode(text) == j.encode(text)
    ids = t.encode(text) + [256, 300]
    assert t.decode(ids) == j.decode(ids)
    js, ts = j.decode_stream(), t.decode_stream()
    assert [ts.step(i) for i in ids] == [js.step(i) for i in ids]
    assert t.eos_token_ids == j.eos_token_ids and t.vocab_size == j.vocab_size


def test_load_tokenizer_refuses_model_files(tmp_path):
    """Model files are read now (tests/test_torch_hf_tokenizer.py,
    test_torch_gguf.py); what is refused is a tokenizer.json outside the
    subset, a directory only ``transformers`` could load, and a missing
    GGUF."""
    assert isinstance(load_tokenizer(None), TToy)
    assert isinstance(load_tokenizer("toy"), TToy)
    (tmp_path / "tokenizer.json").write_text('{"model": {"type": "WordPiece"}}')
    with pytest.raises(ValueError, match="model 'WordPiece'"):
        load_tokenizer(str(tmp_path))
    with pytest.raises(RuntimeError, match="transformers"):
        load_tokenizer(str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path / "m.gguf"))


# -- preprocessor -----------------------------------------------------------
PREPROCESS_CASES = {
    "chat": ("ChatCompletionRequest", {"messages": TEMPLATE_CASES["conversation"],
                                       "max_tokens": 1000, "stop": ["\n\n"]}),
    "chat_raw_prompt": ("ChatCompletionRequest", {
        "messages": TEMPLATE_CASES["parts"], "nvext": {"use_raw_prompt": True}}),
    "chat_parts": ("ChatCompletionRequest", {"messages": TEMPLATE_CASES["parts"]}),
    "chat_ignore_eos_greedy": ("ChatCompletionRequest", {
        "messages": MSG, "ext": {"ignore_eos": True, "greedy": True},
        "temperature": 0.9, "max_completion_tokens": 5}),
    "chat_tools": ("ChatCompletionRequest", {
        "messages": MSG, "tools": [{"type": "function"}], "tool_choice": "none"}),
    "chat_logprobs": ("ChatCompletionRequest", {
        "messages": MSG, "logprobs": True, "top_logprobs": 3}),
    "completion_text": ("CompletionRequest", {"prompt": "abc", "seed": 3}),
    "completion_ids": ("CompletionRequest", {"prompt": [5, 6, 7], "logprobs": 0}),
    "completion_batch": ("CompletionRequest", {"prompt": ["a", "b"]}),
    "completion_empty": ("CompletionRequest", {"prompt": []}),
    "oversized": ("CompletionRequest", {"prompt": "x" * 64}),
    "n": ("ChatCompletionRequest", {"messages": MSG, "n": 2}),
    "best_of": ("CompletionRequest", {"prompt": "a", "best_of": 4}),
    "logit_bias": ("ChatCompletionRequest", {"messages": MSG, "logit_bias": {"1": 1}}),
    "too_many_logprobs": ("ChatCompletionRequest", {
        "messages": MSG, "logprobs": True, "top_logprobs": 99}),
}


def _preprocess(oai, common, pre_mod, card_cls, toy, cls, body):
    req = getattr(oai, cls).model_validate({"model": "m", **body})
    op = pre_mod.OpenAIPreprocessor(card_cls(name="m", context_length=64), toy())
    try:
        return op.preprocess(req).to_wire()
    except common.RequestError as exc:
        return ("RequestError", str(exc))


@pytest.mark.parametrize("case", sorted(PREPROCESS_CASES))
def test_preprocessor_wire_matches(case):
    cls, body = PREPROCESS_CASES[case]
    want = _preprocess(j_oai, j_common, j_pre, JCard, JToy, cls, body)
    got = _preprocess(t_oai, t_common, t_pre, TCard, TToy, cls, body)
    assert got == want


# -- detokenizer ------------------------------------------------------------
def test_stop_string_jail_matches():
    pushes = ["hello S", "T", "OP ignored tail", "ST", "ART", "ab", "cSTO", "x"]
    for stops in (["STOP"], ["STOP", "cS"], [], ["", "T"], ["aaa"]):
        j, t = j_backend.StopStringJail(stops), t_backend.StopStringJail(stops)
        assert [t.push(p) for p in pushes] == [j.push(p) for p in pushes]
        assert t.flush() == j.flush()


def _outputs(tokens_per_step, texts=None, finish_last=None):
    outs = []
    for i, toks in enumerate(tokens_per_step):
        outs.append({"token_ids": toks, "text": texts[i] if texts else None,
                     "finish_reason": None, "cum_tokens": i + 1,
                     "kv_transfer_params": None})
    if finish_last:
        outs.append({"token_ids": [], "text": None, "finish_reason": finish_last,
                     "cum_tokens": len(outs), "kv_transfer_params": None})
    return outs


DETOKENIZE_CASES = {
    "stop_string": ({"stop": ["STOP"]}, _outputs([[b] for b in b"hello STOP never"])),
    "multibyte_split": ({}, _outputs([[b] for b in "a✓b".encode()], finish_last="stop")),
    "two_tokens_a_step": ({"stop": ["lo w"]}, _outputs(
        [list(b"he"), list(b"ll"), list(b"o "), list(b"wo")])),
    "max_tokens": ({"max_tokens": 3}, _outputs([[b] for b in b"abcdef"])),
    "eos": ({}, _outputs([[104], [256], [105]])),
    "eos_ignored": ({"nvext": {"ignore_eos": True}, "max_tokens": 3},
                    _outputs([[104], [256], [105]])),
    "text_native": ({}, _outputs([[], []], texts=["<|user", "|>hi"], finish_last="stop")),
    "out_of_vocab": ({}, _outputs([[300], [104]], finish_last="length")),
}


async def _detokenize(oai, pre_mod, backend, card_cls, toy, ctx_cls, pipeline_cls,
                      adapter, opts, outputs):
    req = oai.CompletionRequest.model_validate({"model": "m", "prompt": "p", **opts})
    pre = pre_mod.OpenAIPreprocessor(card_cls(name="m"), toy()).preprocess(req)

    async def engine(ctx):
        for o in outputs:
            yield dict(o)

    pipe = pipeline_cls.link(backend.Detokenizer(toy()), engine=adapter(engine))
    return [o async for o in pipe.generate(ctx_cls(pre.to_wire()))]


class _Adapter:
    def __init__(self, fn):
        self.generate = fn


@pytest.mark.parametrize("case", sorted(DETOKENIZE_CASES))
def test_detokenizer_deltas_match(case):
    opts, outputs = DETOKENIZE_CASES[case]
    want = asyncio.run(_detokenize(j_oai, j_pre, j_backend, JCard, JToy, JContext,
                                   JPipeline, EngineAdapter, opts, outputs))
    got = asyncio.run(_detokenize(t_oai, t_pre, t_backend, TCard, TToy, TContext,
                                  TPipeline, _Adapter, opts, outputs))
    assert got == want


# -- echo pipelines end to end (in process) ---------------------------------
def _strip(obj):
    if hasattr(obj, "model_dump"):
        obj = obj.model_dump(exclude_none=True)
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    if hasattr(obj, "event"):   # Annotated
        return ("annotated", obj.event, obj.data)
    return obj


PIPELINE_CASES = {
    "chat_core": ("ChatCompletionRequest", "EchoEngineCore",
                  {"messages": MSG, "nvext": {"annotations": ["token_ids",
                                                              "formatted_prompt"]}}),
    "chat_full": ("ChatCompletionRequest", "EchoEngineFull", {"messages": MSG}),
    "completion_ids": ("CompletionRequest", "EchoEngineCore",
                       {"prompt": [104, 105], "max_tokens": 1}),
    "tool_call": ("ChatCompletionRequest", "EchoEngineFull", {
        "messages": [{"role": "user", "content":
                      '{"name": "get_weather", "arguments": {"city": "Oslo"}}'}],
        "nvext": {"use_raw_prompt": True},
        "tools": [{"type": "function", "function": {"name": "get_weather"}}]}),
    "tool_prose": ("ChatCompletionRequest", "EchoEngineFull", {
        "messages": [{"role": "user", "content": "just prose here"}],
        "nvext": {"use_raw_prompt": True}, "tools": [{"type": "function"}]}),
    "tool_required_missing": ("ChatCompletionRequest", "EchoEngineFull", {
        "messages": [{"role": "user", "content": "{not json"}],
        "nvext": {"use_raw_prompt": True}, "tools": [{"type": "function"}],
        "tool_choice": "required"}),
}


async def _pipeline(oai, common, pre_mod, backend, engines, card_cls, toy, ctx_cls,
                    pipeline_cls, cls, engine, body):
    req = getattr(oai, cls).model_validate({"model": "m", **body})
    pipe = pipeline_cls.link(pre_mod.OpenAIPreprocessor(card_cls(name="m"), toy()),
                             backend.Detokenizer(toy()),
                             engine=getattr(engines, engine)())
    out = []
    try:
        async for chunk in pipe.generate(ctx_cls(req)):
            out.append(_strip(chunk))
    except common.RequestError as exc:
        out.append(("RequestError", str(exc)))
    return out   # _strip dropped the fresh call ids too


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_echo_pipeline_chunks_match(case):
    cls, engine, body = PIPELINE_CASES[case]
    want = asyncio.run(_pipeline(j_oai, j_common, j_pre, j_backend, j_engines, JCard,
                                 JToy, JContext, JPipeline, cls, engine, body))
    got = asyncio.run(_pipeline(t_oai, t_common, t_pre, t_backend, t_engines, TCard,
                                TToy, TContext, TPipeline, cls, engine, body))
    assert got == want


def test_tool_call_matcher_matches():
    texts = ['{"name": "f", "parameters": {"a": 1}}',
             '```json\n[{"name": "f", "arguments": {}}, {"name": "g", "arguments": {}}]\n```',
             '[{"name": "f", "arguments": {}}, 3]', "prose", '{"name": 1}']
    for choice in ("auto", "none", "required", {"type": "function",
                                                "function": {"name": "g"}}):
        j, t = j_tools.ToolCallMatcher(choice), t_tools.ToolCallMatcher(choice)
        assert (t.enabled, t.required, t.forced_name) == (j.enabled, j.required,
                                                          j.forced_name)
        for text in texts:
            strip = [[{k: v for k, v in c.items() if k != "id"} for c in m.match(text)]
                     for m in (j, t)]
            assert strip[1] == strip[0]


def test_segment_and_tap_see_both_directions():
    seen = []
    tap = Tap(on_request=lambda ctx: seen.append(("req", ctx.payload)),
              on_response=lambda ctx, item: seen.append(("resp", item)))

    class Upper:
        async def generate(self, request, downstream):
            async for item in downstream.generate(request.map(request.payload + 1)):
                yield item * 10

    async def engine(ctx):
        yield ctx.payload
        yield ctx.payload + 1

    pipe = Segment(Upper()).link(tap).into(_Adapter(engine))

    async def run():
        return [x async for x in pipe.generate(TContext(1))]

    assert asyncio.run(run()) == [20, 30]
    assert seen == [("req", 2), ("resp", 2), ("resp", 3)]


# -- admission and metrics --------------------------------------------------
@pytest.mark.parametrize("stats", [
    {}, {"num_requests_waiting": 9}, {"num_requests_waiting": 40},
    {"prefill_backlog_tokens": 5000}, {"prefill_backlog_tokens": 100},
])
def test_admission_decisions_match(stats):
    kw = dict(max_inflight=3, max_engine_waiting=8, max_prefill_backlog_tokens=1000)
    j = j_adm.AdmissionController(j_adm.AdmissionConfig(**kw), engine_stats=lambda: stats)
    t = t_adm.AdmissionController(t_adm.AdmissionConfig(**kw), engine_stats=lambda: stats)

    def attempt(c, rejected):
        try:
            return ("admitted", c.admit())
        except rejected as exc:
            return ("rejected", exc.reason, exc.retry_after_s, exc.draining)

    def strip(r):
        return r[0] if r[0] == "admitted" else r

    permits = []
    for _ in range(5):
        a, b = attempt(j, j_adm.AdmissionRejected), attempt(t, t_adm.AdmissionRejected)
        assert strip(b) == strip(a)
        permits += [x[1] for x in (a, b) if x[0] == "admitted"]
    for p in permits:
        p.release()
    assert t.inflight == j.inflight == 0
    j.begin_drain()
    t.begin_drain()
    assert strip(attempt(t, t_adm.AdmissionRejected)) == strip(
        attempt(j, j_adm.AdmissionRejected))
    js, ts = j.snapshot(), t.snapshot()
    for key in ts:
        assert ts[key] == js[key], key


def test_metrics_render_matches():
    ms = [j_metrics.Metrics(), t_metrics.Metrics()]
    for m in ms:
        for i, secs in enumerate((0.001, 0.3, 7.0, 100.0)):
            m.observe("m", "chat_completions", "success" if i else "error", secs)
        with m.guard("m", "completions") as g:
            g.success()
        m.set_gauge("draining", 0.0)
        m.set_gauge("shed_requests_total", 2.0)
    text = [m.render() for m in ms]
    # The guard's measured duration differs; every other line is equal.
    strip = [[ln for ln in t.splitlines() if "completions\"" not in ln
              or "chat" in ln] for t in text]
    assert strip[1] == strip[0]
    assert [ln.split("{")[0].split(" ")[0] for ln in text[1].splitlines()] == [
        ln.split("{")[0].split(" ")[0] for ln in text[0].splitlines()]


# -- model card and local model ---------------------------------------------
def test_card_fields_match_the_reference():
    card = TCard(name="m", context_length=128, extra={"a": 1})
    assert vars(JCard(**vars(card))) == vars(card)
    assert vars(TCard(name="m")) == vars(JCard(name="m"))


def test_local_model_serves_presets_and_refuses_checkpoints(tmp_path, monkeypatch):
    """Checkpoints are served now (tests/test_torch_hf_load.py); what is
    refused is an unknown preset and a reference that names no files: a
    snapshot missing from the hub cache, a missing GGUF, a directory
    without config.json."""
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    local = LocalModel.prepare("preset:tiny-test", context_length=64)
    assert local.card.name == "tiny-test" and local.card.context_length == 64
    assert local.card.model_path is None and local.load_params() is None
    with pytest.raises(ValueError):
        LocalModel.prepare("preset:nope")
    for ref in ("hf://org/name", str(tmp_path / "m.gguf"), str(tmp_path)):
        with pytest.raises(FileNotFoundError):
            LocalModel.prepare(ref)


# -- CLI --------------------------------------------------------------------
def test_cli_flags_keep_the_reference_defaults():
    from dynamo_tpu.cli import build_parser as j_parser

    jd = vars(j_parser().parse_args(["run"]))
    td = vars(t_cli.build_parser().parse_args(["run"]))
    assert td.pop("device") == "cuda"
    assert td.pop("output") == "torch" and jd["output"] == "tpu"
    assert td.pop("endpoint") == "dyn://dynamo.torch.generate"
    assert jd["endpoint"] == "dyn://dynamo.tpu.generate"
    missing = [k for k in td if k not in jd]
    assert not missing, missing
    assert {k: td[k] for k in td} == {k: jd[k] for k in td}
    # The planner's flags: the reference's names and defaults, except the
    # decode pool's component (the port's workers serve "torch").
    argv = ["planner", "--control-plane", "h:1", "--worker-cmd", "w"]
    jd = vars(j_parser().parse_args(argv))
    td = vars(t_cli.build_parser().parse_args(argv))
    assert td.pop("decode_component") == "torch" and jd.pop("decode_component") == "tpu"
    assert td == jd


REFUSED = {
    "--out tpu": ["--out", "tpu"],
    "--mesh": ["--mesh", "tp=2"],
    "--kv-sp": ["--kv-sp"],
    "--coordinator": ["--coordinator", "h:1"],
    "--num-nodes": ["--num-nodes", "2"],
    # Served with --out torch since the weight-quant slice; the
    # embeddings engine serves full-precision weights only.
    "--quant": ["--quant", "int8", "--model-type", "embeddings"],
    "--weight-quant": ["--weight-quant", "int8", "--model-type", "embeddings"],
    "--speculative-k": ["--speculative-k", "-1"],
    # Served with --out torch (tests/test_torch_embedding.py); the echo
    # engines serve chat only.
    "--model-type embeddings": ["--model-type", "embeddings", "--out", "echo_core"],
    "--config": ["--config", "x.yaml"],
    "--set": ["--set", "Engine.x=1"],
}


@pytest.mark.parametrize("flag", sorted(REFUSED))
def test_cli_refuses_unserved_flags_by_name(flag):
    with pytest.raises(SystemExit) as exc:
        t_cli.main(["run", *REFUSED[flag]])
    assert isinstance(exc.value.code, str) and flag.split()[0] in exc.value.code


# The runtime plane's flags, refused until the runtime slice, are served;
# so is the KV-aware router's, refused until the KV router slice.
SERVED = {
    "--out dyn": ["--out", "dyn"],
    "--in dyn://": ["--in", "dyn://a.b.c"],
    "--control-plane": ["--control-plane", "h:1"],
    "--spawn-control-plane": ["--spawn-control-plane"],
    "--router-mode random": ["--router-mode", "random"],
    "--router-mode kv": ["--router-mode", "kv", "--route-network-aware"],
}


@pytest.mark.parametrize("flag", sorted(SERVED))
def test_cli_serves_the_runtime_plane_flags(flag):
    t_cli.refuse_unserved(t_cli.build_parser().parse_args(["run", *SERVED[flag]]))


# Deadlines, SLO classes, co-location and profiling, refused until this
# slice, are served; the engine and admission configs carry them.
SERVED_SLO = {
    "--default-deadline-s": ["--default-deadline-s", "2"],
    "--default-request-class": ["--default-request-class", "batch"],
    "--batch-watermark-scale": ["--batch-watermark-scale", "0.25"],
    "--coloc adaptive": ["--coloc", "adaptive", "--itl-slo-ms", "50"],
    "--itl-slo-ms": ["--itl-slo-ms", "50"],
    "--profile-dir": ["--profile-dir", "/nonexistent/profiles"],
}


@pytest.mark.parametrize("flag", sorted(SERVED_SLO))
def test_cli_serves_the_slo_and_observability_flags(flag):
    args = t_cli.build_parser().parse_args(
        ["run", "--device", "cpu", "--model-path", "preset:tiny-test",
         *SERVED_SLO[flag]])
    t_cli.refuse_unserved(args)
    _local, ecfg = t_cli._local_and_cfg(args)
    assert (ecfg.coloc, ecfg.itl_slo_ms, ecfg.coloc_min_quantum) == (
        args.coloc, args.itl_slo_ms, args.coloc_min_quantum)


def test_cli_router_mode_kv_refusal_names_roadmap_a5():
    """``--router-mode kv`` is served now (the name is kept from when it
    was refused): the ``run`` flags and the ``router`` and ``metrics``
    subcommands parse as the JAX CLI's do (the exporter's component
    defaults to the port's ``torch``), and a KV frontend's router
    config is the JAX one's but for the measured link rate."""
    from dynamo_tpu.cli import build_parser as j_parser
    from dynamo_tpu.llm.kv_router.scheduler import KvRouterConfig as JCfg
    from dynamo_tpu_torch.llm.kv_router.scheduler import KvRouterConfig as TCfg

    argvs = (
        ["run", "--out", "dyn", "--router-mode", "kv", "--route-network-aware"],
        ["router", "--control-plane", "h:1", "--endpoint", "dyn://a.b.c",
         "--component", "r2", "--block-size", "32", "--route-network-aware",
         "--replica-id", "3"],
        ["metrics", "--control-plane", "h:1", "--port", "0", "--push-url",
         "http://gw:9091", "--push-interval", "2", "--push-job", "j"],
    )
    for argv in argvs:
        td = vars(t_cli.build_parser().parse_args(argv))
        jd = vars(j_parser().parse_args(argv))
        if argv[0] == "run":
            t_cli.refuse_unserved(t_cli.build_parser().parse_args(argv))
            assert td.pop("device") == "cuda" and td.pop("output") == jd["output"]
            td.pop("endpoint")
        if argv[0] == "metrics":
            assert td.pop("component") == "torch" and jd["component"] == "tpu"
        assert {k: td[k] for k in td} == {k: jd[k] for k in td}, argv
    t, j = vars(TCfg(network_aware=True)), vars(JCfg(network_aware=True))
    assert t.pop("default_link_gbps") > 0
    j.pop("default_link_gbps")
    assert t == j


def test_cli_refuses_non_preset_models_and_bad_dtypes(tmp_path, monkeypatch):
    # Non-preset models are served now: an hf:// reference missing from
    # the hub cache is what is refused, by name.
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    for argv, words in ((["--model-path", "hf://a/b"], "hf://a/b not in the local hub cache"),
                        (["--dtype", "float16"], "dtype")):
        args = t_cli.build_parser().parse_args(["run", *argv, "--device", "cpu"])
        with pytest.raises(SystemExit, match=words):
            t_cli._local_and_cfg(args)


def test_cli_parser_rejects_flags_without_a_counterpart():
    # --profile-dir and --coloc-min-quantum have their counterparts now
    # (torch.profiler windows, the co-location floor): served above.
    for flag in ("--compile-cache-dir",):
        with pytest.raises(SystemExit) as exc:
            t_cli.build_parser().parse_args(["run", flag, "1"])
        assert exc.value.code == 2


def _cli(module, *argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def _report(proc):
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def test_cli_batch_report_has_the_reference_keys(tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("hello world\nsecond prompt\n")
    args = ("run", "--in", f"batch:{prompts}", "--out", "echo_core")
    want = _report(_cli("dynamo_tpu", *args))
    got = _report(_cli("dynamo_tpu_torch", *args))
    assert list(got) == list(want)
    assert got["requests"] == 2 and got["tokens_out_per_s"] > 0


def test_cli_batch_serves_tiny_test_on_the_cpu_when_asked(tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("hello\n")
    common = ("run", "--in", f"batch:{prompts}", "--model-path", "preset:tiny-test",
              "--max-model-len", "64", "--num-blocks", "32", "--max-num-seqs", "4",
              "--max-tokens", "4")
    report = _report(_cli("dynamo_tpu_torch", *common, "--device", "cpu"))
    assert report["requests"] == 1
    import torch

    if not torch.cuda.is_available():
        proc = _cli("dynamo_tpu_torch", *common)
        assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_cli_text_mode_chats_as_the_reference_does():
    def chat(module):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-m", module, "run", "--in", "text", "--out", "echo_full"],
            cwd=REPO, env=env, input="hello\nagain\n\n", capture_output=True,
            text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr
        return [ln for ln in proc.stdout.splitlines() if "<|" in ln]

    want = chat("dynamo_tpu")
    assert chat("dynamo_tpu_torch") == want
    assert "<|user|>hello</s><|assistant|>" in want[0]
