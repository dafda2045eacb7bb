"""Port parity: ``acvae_tpu_torch.core`` (the YAML subset reader and
``load_config``) against PyYAML's ``safe_load`` and ``acvae_tpu.core.config``.

Every comparison is exact (``==`` on the loaded values, and equal types).
"""
import math
from pathlib import Path

import pytest
import yaml

from acvae_tpu.core.config import dump_config
from acvae_tpu.core.config import load_config as j_load_config
from acvae_tpu_torch.core.config import Config, _coerce, load_config
from acvae_tpu_torch.core.miniyaml import safe_load

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))
OVERRIDES = [
    {},
    {"ss_args.ss_mode": "linear", "augments": "[timewarp,timemask]",
     "optimizer_args.lr": "1e-3"},
    {"epochs": "2", "resume": "true", "encoder_args.channels": "[4, 8, 8, 16]",
     "outputpath": "/tmp/x", "scheduler_args": "{}", "new.nested.key": "~"},
]


def _same(a, b):
    """Equal values of equal types, recursively (so 1 != 1.0 != True)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(k, l) and _same(a[k], b[l]) for k, l in zip(a, b)))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_matches_pyyaml_on_the_configs(path):
    text = path.read_text()
    assert _same(safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("overrides", OVERRIDES, ids=["plain", "dotted", "more"])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_matches_jax(path, overrides):
    ours = load_config(str(path), **overrides)
    ref = j_load_config(str(path), **overrides)
    assert isinstance(ours, Config) and _same(dict(ours), dict(ref))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_dump_config_reads_back(path, tmp_path):
    """JAX's ``dump_config`` (``yaml.safe_dump``: block sequences at the
    key's indentation, sorted keys, quoted look-alike strings) reads back
    equal."""
    conf = j_load_config(str(path), augments="[timewarp,timemask]")
    conf.update(data_dim=64, total_iters=1350, note="1e-3", flag="yes",
                empty="", tilde="~", num_str="012", nested={"a": [1, [2, {}]]})
    out = tmp_path / "config.yaml"
    dump_config(conf, str(out))
    assert _same(load_config(str(out)), j_load_config(str(out)))
    assert _same(safe_load(out.read_text()), yaml.safe_load(out.read_text()))


SCALARS = [
    # bool, null
    "yes", "Yes", "NO", "true", "False", "on", "OFF", "y", "n", "~", "null",
    "Null", "NULL", "", "nul",
    # int: decimal, separators, octal, binary, hex, base 60, signs
    "0", "12", "-3", "+4", "1_000", "012", "09", "0o7", "0b101", "-0b11",
    "0x1F", "+0x10", "1:20", "-1:30:00", "0_7",
    # float: a dot is required, an exponent needs its sign
    "1.5", "3.", ".5", "-2.25", "1.0e-05", "1.e+5", "1e-3", "1.0e5",
    "1_0.5_0", "._5", "1:20.5", "1.5:20", ".inf", "-.Inf", "+.INF", ".nan",
    # strings
    "abc", "a b c", "it's", "a#b", "a #comment", "http://x:80/a", "'q'",
    "'it''s'", '"tab\\tand\\u00e9"', '"a #b"', "-x", "a:b", "[a, b, ]",
    "[timewarp,timemask]", "{a: 1, b: [x, 'y', {c: }]}", "[]", "{}",
    "[1, 2.0, '3', \"4\", yes, ~]", "{a}",
]


@pytest.mark.parametrize("text", SCALARS, ids=lambda s: repr(s))
def test_reader_resolves_scalars_as_pyyaml(text):
    assert _same(safe_load(text), yaml.safe_load(text))
    assert _same(_coerce(text), yaml.safe_load(text))


DOCUMENTS = [
    "a: 1\nb:\n  c: [1, 2]\n  d: ~\n",
    "x:\n- 1\n- 2\ny: 3\n",
    "- a: 1\n  b: 2\n- c\n- - 3\n  - 4\n",
    "k:\n  v\n",
    "# head\n\na: 1   # trailing\n\n# tail\n",
    "'a b': 1\n1: x\ntrue: y\n~: z\n",
    "a:\n  - x\n  -\n    - y\n",
    "- \n- ''\n- \"\"\n",
    "a: {b: {c: [1, {d: 2}]}, e: []}\n",
]


@pytest.mark.parametrize("text", DOCUMENTS, ids=range(len(DOCUMENTS)))
def test_reader_matches_pyyaml_on_documents(text):
    assert _same(safe_load(text), yaml.safe_load(text))


UNSUPPORTED = [
    ("&a x", "anchors"), ("*a", "anchors"), ("!!str 1", "tags"),
    ("a: |\n  x\n", "block scalars"), ("a: >\n  x\n", "block scalars"),
    ("---\na: 1\n---\nb: 2\n", "documents"), ("%YAML 1.1\na: 1\n", "directives"),
    ("? a\n: b\n", "complex keys"), ("a: b: c\n", "mapping value"),
    ("a: 2002-12-14\n", "timestamps"), ("a: 1\n  b: 2\n", "line 2"),
    ("a: this is\n  continued\n", "line 2"), ("x: 'unclosed\n", "quoted"),
    ("a: [1, 2\n", "unclosed"), ("a: [1,\n  2]\n", "unclosed"), ("<<: {a: 1}\n", "merge"),
    ("[a: 1]", "single-pair"), ("a:\n\t- x\n", "tabs"),
]


@pytest.mark.parametrize("text,match", UNSUPPORTED, ids=[m for _, m in UNSUPPORTED])
def test_unsupported_yaml_raises_with_the_line(text, match):
    with pytest.raises(ValueError, match=match) as e:
        safe_load(text)
    assert "line" in str(e.value)


def test_coerce_keeps_strings_the_reader_refuses():
    """As JAX's ``_coerce`` keeps the string on a YAMLError."""
    for text in ("*a", "a: b: c", "[unclosed"):
        assert _coerce(text) == text
        with pytest.raises(yaml.YAMLError):
            yaml.safe_load(text)
    assert _coerce(5) == 5 and _coerce(True) is True


def test_config_attribute_and_dotted_access(tmp_path):
    cfg = load_config(str(ROOT / "configs/ac_vae.yaml"), **{"a.b.c": "1"})
    assert cfg.ss_args.ss_mode == "exponential" and cfg.get_path("a.b.c") == 1
    cfg.model_args.prior_args["hidden_size"] = 7      # a live view
    assert cfg["model_args"]["prior_args"]["hidden_size"] == 7
    assert cfg.get_path("nope.x", "d") == "d"
    with pytest.raises(AttributeError):
        cfg.missing
    (tmp_path / "list.yaml").write_text("- a\n- b\n")
    with pytest.raises(ValueError, match="mapping"):
        load_config(str(tmp_path / "list.yaml"))
