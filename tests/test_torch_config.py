"""The port's layered config (dynamo_tpu_torch/utils/config.py) and its
YAML subset against the JAX package's (dynamo_tpu/utils/config.py, which
parses with ``yaml.safe_load``): tests/test_config.py's seven tests run
through both packages on the same files, every YAML here and
deploy/deploy.example.yaml parse equal to ``yaml.safe_load``, the
constructs outside the subset are refused by name, and the CLI layers
``--config``/environment/``--set`` onto its flags with the reference's
precedence (a config's ``out: tpu`` is refused as the flag is)."""

import math
from pathlib import Path

import pytest

from dynamo_tpu import cli as j_cli
from dynamo_tpu.utils.config import load_config as j_load
from dynamo_tpu_torch import cli as t_cli
from dynamo_tpu_torch.utils.config import YamlSubsetError, load_config, yaml_load

yaml = pytest.importorskip("yaml")

REPO = Path(__file__).resolve().parent.parent

YAML = """
Common:
  model-path: /models/llama
  block-size: 32

Frontend:
  port: 9000

Engine:
  common-configs: [model-path, block-size]
  max-num-seqs: 16
"""


def _write(tmp_path, text):
    p = tmp_path / "deploy.yaml"
    p.write_text(text)
    return p


def _both(*args, **kw):
    got, want = load_config(*args, **kw), j_load(*args, **kw)
    assert got.sections() == want.sections()
    for s in want.sections():
        assert got.component(s).as_dict() == want.component(s).as_dict(), s
    return got


def test_yaml_sections_and_common_inheritance(tmp_path):
    cfg = _both(_write(tmp_path, YAML), env={})
    eng = cfg.component("Engine")
    assert eng.get("model_path") == "/models/llama"
    assert eng.get("block-size") == 32
    assert eng.get("max_num_seqs") == 16
    fe = cfg.component("Frontend")
    assert fe.get("port") == 9000 and fe.get("model_path") is None
    assert "Common" not in cfg.sections()


def test_common_reference_to_missing_key_rejected(tmp_path):
    bad = _write(tmp_path, "Common:\n  a: 1\nEngine:\n  common-configs: [missing]\n")
    for load in (load_config, j_load):
        with pytest.raises(KeyError, match="missing"):
            load(bad)


def test_env_layer_refines_known_sections_only(tmp_path):
    env = {"DYNTPU_ENGINE_MAX_NUM_SEQS": "64", "DYNTPU_ENGINE_DTYPE": "float32",
           "DYNTPU_LOG": "debug", "DYNTPU_NOSUCH_KEY": "1",
           "DYNTPU_ENGINE_LIST": "[a, 1, yes]", "DYNTPU_FRONTEND_HOST": "0.0.0.0"}
    cfg = _both(_write(tmp_path, YAML), env=env)
    eng = cfg.component("Engine")
    assert eng.get("max_num_seqs") == 64 and eng.get("dtype") == "float32"
    assert eng.get("list") == ["a", 1, True]
    assert cfg.sections() == ["Engine", "Frontend"]


def test_overrides_beat_file_and_env(tmp_path):
    cfg = _both(_write(tmp_path, YAML),
                overrides=["Engine.max-num-seqs=8", "Router.mode=kv", "Engine.x=0x10",
                           "Engine.y=1.5", "Engine.z=~", "Engine.w='08'"],
                env={"DYNTPU_ENGINE_MAX_NUM_SEQS": "64"})
    assert cfg.component("Engine").get("max_num_seqs") == 8
    assert cfg.component("Router").get("mode") == "kv"
    assert cfg.component("Engine").get("x") == 16


def test_bad_override_shape():
    for load in (load_config, j_load):
        with pytest.raises(ValueError, match="Component.key=value"):
            load(overrides=["noequals"])
        with pytest.raises(ValueError, match="Component.key=value"):
            load(overrides=["nodot=1"])


def test_component_config_helpers():
    cfg = _both(overrides=["Engine.num-blocks=128"], env={})
    eng = cfg.component("Engine")
    assert "num_blocks" in eng and "nope" not in eng
    assert eng.require("num_blocks") == 128
    with pytest.raises(KeyError):
        eng.require("nope")

    class Obj:
        num_blocks = 0
        other = "keep"

    obj = eng.apply_to(Obj())
    assert obj.num_blocks == 128 and obj.other == "keep"


CLI_YAML = """
Run:
  out: echo_core
Frontend:
  port: 18080
Engine:
  max-num-seqs: 4
  warmup: false
"""


def _applied(argv):
    """The port's and the JAX CLI's args after layering, flag by flag."""
    t = t_cli.build_parser().parse_args(argv)
    j = j_cli.build_parser().parse_args(argv)
    t_cli._apply_config(t)
    j_cli._apply_config(j)
    for k in ("output", "http_port", "max_num_seqs", "no_warmup", "kv_cache_block_size",
              "router_mode", "http_host", "model_path"):
        assert getattr(t, k) == getattr(j, k), k
    return t


def test_cli_apply_config(tmp_path, monkeypatch):
    for var in [v for v in __import__("os").environ if v.startswith("DYNTPU_")]:
        monkeypatch.delenv(var)
    path = _write(tmp_path, CLI_YAML)
    args = _applied(["run", "--config", str(path), "--set", "Engine.max-num-seqs=2"])
    assert args.output == "echo_core" and args.http_port == 18080
    assert args.max_num_seqs == 2 and args.no_warmup is True
    # Explicit flags beat the file; --set beats even explicit flags.
    assert _applied(["run", "--config", str(path), "--http-port", "9000"]).http_port == 9000
    assert _applied(["run", "--config", str(path), "--max-num-seqs", "64",
                     "--set", "Engine.max-num-seqs=2"]).max_num_seqs == 2
    # The environment layer sits with the file, under the flags.
    monkeypatch.setenv("DYNTPU_ENGINE_BLOCK_SIZE", "32")
    assert _applied(["run", "--config", str(path)]).kv_cache_block_size == 32
    for bad, words in ((["--set", "Frontend.warmup=false"], "warmup"),
                       (["--set", "Engine.no-such-knob=1"], "no-such-knob"),
                       (["--set", "Nope.x=1"], "Nope"),
                       (["--config", str(tmp_path / "missing.yaml")], "missing.yaml")):
        args = t_cli.build_parser().parse_args(["run", *bad])
        with pytest.raises(SystemExit, match=words):
            t_cli._apply_config(args)


def test_cli_refuses_a_config_value_as_it_refuses_the_flag(tmp_path):
    """deploy/deploy.example.yaml says ``out: tpu`` (the JAX engine) and a
    mesh: the port refuses them from the file as from the command line."""
    with pytest.raises(SystemExit, match="--out tpu"):
        t_cli.main(["run", "--config", str(REPO / "deploy" / "deploy.example.yaml")])
    path = _write(tmp_path, "Run:\n  out: torch\nEngine:\n  mesh: tp=4\n")
    with pytest.raises(SystemExit, match="--mesh"):
        t_cli.main(["run", "--config", str(path)])
    with pytest.raises(SystemExit, match="--quant.*A3"):
        t_cli.main(["run", "--set", "Engine.quant=int8"])


# -- the YAML subset ---------------------------------------------------------

DOCS = {
    "deploy_example": (REPO / "deploy" / "deploy.example.yaml").read_text(),
    "test_config": YAML,
    "cli": CLI_YAML,
    "scalars": """
ints: [0, 7, -3, +4, 0x1F, 017, 0b101, 1_000, 1:30, 08]
floats: [1.5, -2., .5, 1.0e+5, 1:30.5, .inf, -.Inf, +.INF]
bools: [yes, No, TRUE, off, On, y, n]
nulls: [~, null, Null, NULL]
strings: [1e5, 0x, hello world, 'single ''quoted''', "dbl \\t \\u00e9 \\x41 \\\\ \\"", a:b]
""",
    "blocks": """
# comment
top:   # trailing comment
  - plain
  - key: 1
    other: [a, {b: c}]
  -
  - - nested
    - seq
mapping:
  deep:
    deeper: "x # not a comment"
  empty:
  'quoted key': v
seq_at_key_indent:
- 1
- 2
flow: {a: 1, b: [x, y], c: }
multi_line_flow: [a,
  b, c]
""",
    "document_start": "---\na: 1\nb: [2]\n",
    "top_sequence": "- a\n- b: c\n",
    "scalar": "just text",
    "empty": "# nothing\n",
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_yaml_subset_equals_safe_load(name):
    got, want = yaml_load(DOCS[name]), yaml.safe_load(DOCS[name])

    def norm(v):  # NaN != NaN: compare by repr
        if isinstance(v, float) and math.isnan(v):
            return "nan"
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, list):
            return [norm(x) for x in v]
        return v, type(v).__name__

    assert norm(got) == norm(want)


REFUSED = {
    "anchor": ("a: &x 1\nb: 2\n", "anchors"),
    "alias": ("a: 1\nb: *x\n", "aliases"),
    "tag": ("a: !!str 1\n", "tags"),
    "block_scalar": ("a: |\n  text\n", "block scalars"),
    "folded_scalar": ("a: >\n  text\n", "block scalars"),
    "documents": ("a: 1\n---\nb: 2\n", "multiple YAML documents"),
    "complex_key": ("? a\n: b\n", "complex keys"),
    "merge_key": ("base: {a: 1}\nother:\n  <<: {b: 2}\n", "merge keys"),
    "timestamp": ("a: 2001-12-14\n", "timestamp"),
    "multi_line_plain": ("a: one\n  two\n", "multi-line plain scalar"),
    "directive": ("%YAML 1.1\n---\na: 1\n", "directives"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_constructs_outside_the_subset_are_refused_by_name(case, tmp_path):
    text, words = REFUSED[case]
    with pytest.raises(YamlSubsetError, match=words):
        yaml_load(text)
    with pytest.raises(YamlSubsetError, match=words):
        load_config(_write(tmp_path, text))
