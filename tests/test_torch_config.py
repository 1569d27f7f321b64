"""psnerf_torch's config loaders against psnerf_tpu's:
  * every shipped configs/stage1/*.yaml and configs/stage2/*.conf, and the
    configs of tests/test_cli.py, give equal dataclasses in both packages
    (dataclasses.asdict, every value and its Python type, no tolerance);
  * the port's own YAML parser (no PyYAML) against yaml.safe_load on the
    shipped files, edge cases (5e-4 stays a string, 1.0e-3 is a float,
    YAML 1.1 booleans, ~, empty values, quoted #, nested inherit_from) and
    a hypothesis strategy over the subset; syntax outside it raises
    ValueError naming the line;
  * the HOCON cases of tests/test_config.py against the port's parser.
"""

import dataclasses
import re
import textwrap
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from psnerf_tpu import config as jconfig
from psnerf_torch import config as pconfig
from torch_helpers import CLI_STAGE1_YAML, CLI_STAGE2_CONF

ROOT = Path(__file__).resolve().parents[1]
# tiling knobs of the JAX package's Stage1TrainConfig that the port's has
# no counterpart of (its kernels pick their own tiles); the loaders set none
JAX_ONLY = {"occ_tile", "radiance_tile", "fused_interpret"}


def typed(x):
    """A nested structure that compares equal only when values and their
    Python types are equal (True != 1, 5e-4 != '5e-4')."""
    if isinstance(x, dict):
        return ("dict", tuple(sorted(((typed(k), typed(v))
                                      for k, v in x.items()), key=repr)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(typed(v) for v in x))
    return (type(x).__name__, x)


def _typed_asdict(cfg):
    """typed() of a config's dataclasses.asdict, without JAX_ONLY keys."""
    def strip(d):
        return {k: strip(v) if isinstance(v, dict) else v
                for k, v in d.items() if k not in JAX_ONLY}
    return typed(strip(dataclasses.asdict(cfg)))


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "configs" / "stage1").glob("*.yaml")))
def test_shipped_stage1_yaml_matches_jax(name, monkeypatch):
    monkeypatch.chdir(ROOT)                 # inherit_from is repo-relative
    path = f"configs/stage1/{name}"
    got = pconfig.stage1_config_from_yaml(path)
    assert _typed_asdict(got) == _typed_asdict(
        jconfig.stage1_config_from_yaml(path))
    assert got.field.hidden_dim == 256 and got.render.ray_marching_steps == 256


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "configs" / "stage2").glob("*.conf")))
def test_shipped_stage2_conf_matches_jax(name):
    path = str(ROOT / "configs" / "stage2" / name)
    got = pconfig.stage2_config_from_conf(path)
    assert _typed_asdict(got) == _typed_asdict(
        jconfig.stage2_config_from_conf(path))
    assert got.obj_name == name[:-5] and got.net.specular_rgb


def test_cli_configs_are_test_cli_s_and_match_jax(tmp_path):
    """The templates in torch_helpers are tests/test_cli.py's own text, and
    both packages load them into equal dataclasses."""
    src = (ROOT / "tests" / "test_cli.py").read_text()
    assert CLI_STAGE1_YAML in src and CLI_STAGE2_CONF in src
    kw = dict(scene=str(tmp_path / "scene"), root=str(tmp_path))
    (tmp_path / "s1.yaml").write_text(CLI_STAGE1_YAML.format(**kw))
    (tmp_path / "s2.conf").write_text(CLI_STAGE2_CONF.format(**kw))
    s1, s2 = str(tmp_path / "s1.yaml"), str(tmp_path / "s2.conf")
    got1 = pconfig.stage1_config_from_yaml(s1)
    assert _typed_asdict(got1) == _typed_asdict(
        jconfig.stage1_config_from_yaml(s1))
    assert got1.inten_normalize is None and got1.data_dir == kw["scene"]
    got2 = pconfig.stage2_config_from_conf(s2)
    assert _typed_asdict(got2) == _typed_asdict(
        jconfig.stage2_config_from_conf(s2))
    assert got2.stage1_shape_path == f"{tmp_path}/s1_out/shape_out"


def test_yaml_quirks_reach_the_dataclass(tmp_path, monkeypatch):
    """5e-4 is the string '5e-4' in both packages' Stage1TrainConfig (PyYAML
    needs a dot and a signed exponent for a float); 1.0e-3 is a float."""
    monkeypatch.chdir(ROOT)
    p = tmp_path / "q.yaml"
    p.write_text("inherit_from: configs/stage1/default.yaml\n"
                 "training:\n  learning_rate: 5e-4\n  weight_decay: 1.0e-3\n"
                 "  mask_loss: yes\n")
    got = pconfig.stage1_config_from_yaml(str(p))
    assert got.train.learning_rate == "5e-4"
    assert got.train.weight_decay == 1e-3 and got.train.weights.use_mask_loss
    assert _typed_asdict(got) == _typed_asdict(
        jconfig.stage1_config_from_yaml(str(p)))


def test_nested_inherit_from_matches_jax(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("a:\n  x: 1\n  y: 2\n  z:\n    deep: on\nb: 3\n")
    mid = tmp_path / "mid.yaml"
    mid.write_text(f"inherit_from: {base}\na:\n  y: 20\n  z:\n    more: ~\n")
    child = tmp_path / "child.yaml"
    child.write_text(f"inherit_from: {mid}\na:\n  x: '1'\nc: [4, 5.0]\n")
    got = pconfig.load_yaml_config(str(child))
    assert typed(got) == typed(jconfig.load_yaml_config(str(child)))
    assert got["a"] == {"x": "1", "y": 20, "z": {"deep": True, "more": None}}
    assert got["inherit_from"] == str(mid)


# ------------------------------------------------------ the YAML parser

EDGE_CASES = [
    "lr: 5e-4", "lr: 1.0e-3", "lr: 1.0e3", "lr: 1e3", "lr: 1.e-3",
    "lr: .5", "lr: -.5", "lr: +.5", "x: 0.0001", "x: -3", "x: +7",
    "x: 0x1F", "x: 017", "x: 08", "x: 0b101", "x: 1_000", "x: 1:30",
    "x: 1:30.5", "x: .inf", "x: -.Inf", "x: .NaN_",
    "b: yes", "b: No", "b: on", "b: OFF", "b: True", "b: false", "b: y",
    "b: n", "b: TRUE", "b: tRue",
    "n: ~", "n: null", "n: Null", "n: NULL", "n:", "n:   # only a comment",
    "s: 'a # b'", 's: "a # b"', "s: a#b", "s: a # b", "s: 'it''s'",
    's: "tab\\tx\\u00e9\\x41"', "s: b:c", "s: http://x.y/z", "s:  a   b  ",
    "s: OVERRIDE_ME", "s: -x", "s: :x", "s: x,y]",
    "l: [4000, 8000]", "l: []", "l: [ ]", "l: [1, 2, ]", "l: [[1], [2, 3]]",
    "l: ['a, b', \"c\", d e, 5e-4, 1.0e-3, yes, ~]",
    "yes: 1", "1: one", "null: z", "'quoted key': 1", '"k": v',
    "a:\n  b:\n    c: 1\n  d:\nf: 2",
    "a:\n    b: 1\n    c:\n        d: [1]\ne:",
    "  a: 1\n  b: 2",
    "a: 1\na: 2",
    "a:\n  x: 1\na:\n  y: 2",
    "# only\n\n   \n# comments",
    "\n\na: 1   # trailing\n\n# c\nb: 2\n",
    "a: 1\r\nb: 2\r\n",
]


def _same(got, want):
    # NaN != NaN: compare its repr
    norm = lambda v: typed(v) if v == v else ("nan",)
    if isinstance(want, dict) and isinstance(got, dict):
        return (list(got) == list(want) and all(
            _same(got[k], want[k]) for k in want))
    return norm(got) == norm(want)


@pytest.mark.parametrize("text", EDGE_CASES)
def test_yaml_edge_cases_match_safe_load(text):
    want = yaml.safe_load(text)
    got = pconfig.parse_yaml(text)
    assert _same(got, want), (text, got, want)


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "configs" / "stage1").glob("*.yaml")))
def test_yaml_shipped_files_match_safe_load(name):
    text = (ROOT / "configs" / "stage1" / name).read_text()
    assert typed(pconfig.parse_yaml(text)) == typed(yaml.safe_load(text))


@pytest.mark.parametrize("text,line", [
    ("a: 1\n- b", 2), ("a: [1,,2]", 1), ("a: -", 1), ("a: [1 #x]", 1),
    ("a:\n  b: 1\n a2: 2", 3), ("a: &x 1", 1), ("a: *x", 1), ("a: !!int 1", 1),
    ("a: |\n  t", 1), ("a: >\n  t", 1), ("a: {b: 1}", 1), ("---\na: 1", 1),
    ("a: 2001-12-14", 1), ("a: b: c", 1), ("a: 'x' y", 1), ("a:\n\tb: 1", 2),
    ("a: 1\n  b: 2", 2), ("a: 'open", 1), ("a: [1, 2", 1), ("just text", 1),
    ("a: 1\nb: multi\n  line", 3), ("a: <<", 1), ("%YAML 1.1\na: 1", 1),
    ('a: "bad \\q"', 1),
])
def test_yaml_outside_the_subset_raises(text, line):
    with pytest.raises(ValueError, match=f"YAML line {line}:"):
        pconfig.parse_yaml(text)


# hypothesis: documents of the subset, rendered with varied formatting
_TS = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_plain_chars = st.sampled_from(list("abcxyzABZ0123456789._-/+"))
_plain = st.text(_plain_chars, min_size=1, max_size=8).filter(
    lambda s: s[0] not in "-+." and not _TS.match(s))
_number = st.one_of(
    st.integers(-10 ** 6, 10 ** 6).map(str),
    st.floats(allow_nan=False, allow_infinity=False, width=32).flatmap(
        lambda f: st.sampled_from([repr(f), f"{f:e}", f"{f:.3g}",
                                   f"{f:.2e}", f"{f:.1f}"])),
    st.sampled_from(["5e-4", "1.0e-3", "1e3", "1.0E+2", "0x1f", "017",
                     "1_000", "2:30", ".5", "-.5", ".inf", "-.inf", "0"]))
_word = st.sampled_from(["yes", "No", "on", "OFF", "true", "False", "y", "n",
                         "~", "null", "NULL", "Null", "nil", "none"])
_quoted = st.text(st.sampled_from(list("ab #:,[]'x1 ")), max_size=6).flatmap(
    lambda s: st.sampled_from(["'" + s.replace("'", "''") + "'",
                               '"' + s + '"']))
_scalar = st.one_of(_number, _word, _plain, _quoted)
_flow = st.lists(_scalar, max_size=4).map(
    lambda xs: "[" + ", ".join(xs) + "]")
_key = st.one_of(st.from_regex(r"[a-z_][a-z0-9_]{0,6}", fullmatch=True),
                 st.sampled_from(["on", "yes", "1", "null", "'q k'"]))
_doc = st.recursive(
    st.one_of(_scalar, _flow, st.just("")),
    lambda kids: st.dictionaries(_key, kids, min_size=1, max_size=4),
    max_leaves=12)


def _render(doc, indent: int, step: int, comment: bool) -> list:
    lines = []
    for k, v in doc.items():
        pad = " " * indent
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:")
            lines += _render(v, indent + step, step, comment)
        else:
            tail = "   # note: x" if comment and v else ""
            lines.append(f"{pad}{k}: {v}{tail}".rstrip())
    return lines


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(doc=_doc.filter(lambda d: isinstance(d, dict)),
       step=st.sampled_from([2, 4]), comment=st.booleans())
def test_yaml_hypothesis_matches_safe_load(doc, step, comment):
    text = "\n".join(_render(doc, 0, step, comment)) + "\n"
    want = yaml.safe_load(text)
    got = pconfig.parse_yaml(text)
    assert _same(got, want), text


# --------------------------------------------------------------- HOCON

def test_parse_hocon_reference_subset():
    """tests/test_config.py:15 on the port."""
    conf = pconfig.parse_hocon(textwrap.dedent("""
        dataset{
            obj_name = bear
            data_dir = ../dataset/bear   # trailing comment
            inten_normalize = sdps
        }
        train{
            light_train = True
            light_bs = 10
            sg_learning_rate = 5e-4
            sg_sched_milestones = [200,400,600,800,1000]
            nested{
                deep = 3
            }
        }
        loss{
            sg_rgb_weight = 1.0
        }
    """))
    assert conf["dataset"]["obj_name"] == "bear"
    assert conf["train"]["light_train"] is True
    assert conf["train"]["light_bs"] == 10
    assert conf["train"]["sg_learning_rate"] == 5e-4
    assert conf["train"]["sg_sched_milestones"] == [200, 400, 600, 800, 1000]
    assert conf["train"]["nested"]["deep"] == 3
    assert pconfig.hocon_get(conf, "loss.sg_rgb_weight") == 1.0
    assert pconfig.hocon_get(conf, "missing.key", 42) == 42


def test_hocon_single_line_blocks_and_separators():
    """tests/test_config.py:106 on the port, each result also equal to the
    JAX parser's."""
    parse = pconfig.parse_hocon
    multi = parse("\ntrain {\n    lr = 5e-4\n    flag = true\n}\n"
                  "net { width = 256 }\n")
    single = parse("train { lr = 5e-4, flag = true }\nnet { width = 256 }")
    assert single == multi
    assert single["train"]["lr"] == 5e-4
    assert single["net"]["width"] == 256
    nested = parse("a { b { c = 1 } d = [1, 2, 3] }")
    assert nested == {"a": {"b": {"c": 1}, "d": [1, 2, 3]}}
    colon = parse('k : "a # not-a-comment" // trailing\nm = x.y.Z')
    assert colon == {"k": "a # not-a-comment", "m": "x.y.Z"}
    merged = parse("a { x = 1 }\na { y = 2 }")
    assert merged == {"a": {"x": 1, "y": 2}}
    for text in ("a { b { c = 1 } d = [1, 2, 3] }", "a { x = 1 }\na { y = 2 }",
                 'k : "a # not-a-comment" // trailing\nm = x.y.Z'):
        assert typed(parse(text)) == typed(jconfig.parse_hocon(text))


@pytest.mark.parametrize("bad", ["a { b = 1", "a }", "= 3", "key", "a { b }"])
def test_hocon_rejects_unparsable_syntax(bad):
    """tests/test_config.py:136 on the port."""
    with pytest.raises(ValueError):
        pconfig.parse_hocon(bad)

