"""Port parity for the config schema and its YAML reader: the port's
``load_config`` against the JAX package's on every ``configs/*.yml``, with
PyYAML and through ``yaml_lite`` with PyYAML hidden; ``yaml_lite``
against ``yaml.safe_load`` on every config and on scalar edge cases;
``_normalize``'s legacy generations; the override registries; the dump.
Every comparison is exact (``==`` on ``dataclasses.asdict``)."""

import dataclasses
import math
import sys
import warnings
from pathlib import Path

import pytest
import yaml

from codenerf_tpu.config import schema as jschema
from codenerf_tpu_torch.config import schema as pschema
from codenerf_tpu_torch.config import yaml_lite
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yml"))
OVERRIDES = ["optimizer.lr=3e-4", "experiment.id=over",
             "runtime.checkify=True",
             "models.nerf_fine.skip_connect_ids=[2, 5]",
             "optimizer.angle_lr=None", "dataset.basedir=/data/x y",
             "nerf.point_sampler.spacing_mode=lindisp"]


def test_all_nine_configs_are_found():
    assert len(CONFIGS) == 9


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "ov"])
def test_load_config_matches_jax(path, overrides):
    want = dataclasses.asdict(jschema.load_config(path, overrides))
    assert dataclasses.asdict(pschema.load_config(path, overrides)) == want


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "ov"])
def test_load_config_without_pyyaml_matches_jax(path, overrides,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)    # import yaml fails
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    got = pschema.load_config(path, overrides)
    monkeypatch.undo()
    assert got == pschema.load_config(path, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jschema.load_config(path, overrides))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_lite_reads_every_config_as_pyyaml(path):
    text = path.read_text()
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)


EDGE = ["1e-5", "1.0e-05", "1.0E-3", "5.0E-3", "1.0e5", "-1.5e+3", "True",
        "true", "TRUE", "yes", "No", "on", "Off", "null", "Null", "~", "",
        "''", '""', "'it''s'", '"lindepth"', '"a\\tb\\u00e9"', "0x1F", "017",
        "09", "0b101", "1_000", "1:30", "1.5:30", "+1", "-0", "0.", "._5",
        ".5", "+.inf", "-.inf", ".NaN", "abc def", "http://x:80/y",
        "[1, 2.5, {a: b}]", "{type: CodeNeRFModel, hidden_size: 64}",
        "{a: }", "[]", "{}"]


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("scalar", EDGE)
def test_yaml_lite_scalars_resolve_as_pyyaml(scalar):
    text = f"v: {scalar}  # comment\n"
    want, got = yaml.safe_load(text)["v"], yaml_lite.safe_load(text)["v"]
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("text", [
    "a: 2001-12-14", "a: &x 1", "a: *x", "a: !!str x", "a: |\n  b",
    "---\na: 1", "a:\n\tb: 1", "a: 'x\n  y'", "a: b\n  c: d", "a: [1, 2",
    "a:\n  - b: 1", "a: =", "a: b: c"])
def test_yaml_lite_refuses_outside_the_subset_with_a_line(text):
    with pytest.raises(ValueError, match=r"line \d+"):
        yaml_lite.safe_load(text)


def test_yaml_lite_nesting_and_indentless_lists():
    text = ("a:\n  b:\n    - 1\n    - 2\n  c:\n  - x\n  d: {e: [1, {f: g}]}\n"
            "h:\n  # comment\n  i: 'q # not a comment'\nj: -3\n")
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)
    assert yaml_lite.safe_load("") is None and yaml.safe_load("") is None


# the three schema generations _normalize reads; the repository's
# configs are all modern, so the older two are written out here
LEGACY = {"models": {
    "coarse": {"type": "FlexibleNeRFModel", "num_layers": 4,
               "skip_connect_ids": [2], "num_encoding_fn_xyz": 6,
               "use_viewdirs": False, "skip_connect_every": 3},
    "fine": {"type": "FlexibleNeRFModel", "hidden_size": 64}},
    "dataset": {"type": "BlenderNeRFDataset", "basedir": "x"}}
FLAT = {"experiment": {"train_iters": 1234, "id": "fern"},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.2},
        "dataset": {"type": "llff", "near": 0.1, "far": 2.0},
        "nerf": {"train": {"num_random_rays": 1024, "num_coarse": 48,
                           "num_fine": 96, "lindisp": True, "perturb": False,
                           "chunksize": 2048},
                 "validation": {"chunksize": 512}}}


@pytest.mark.parametrize("raw", [LEGACY, FLAT, {}, None],
                         ids=["legacy", "flat", "empty", "none"])
def test_config_from_dict_normalizes_as_jax(raw):
    got = pschema.config_from_dict(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jschema.config_from_dict(raw))


def test_deprecated_key_warns_and_is_ignored():
    base = pschema.Config()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        cfg = pschema._apply_override(
            base, "models.nerf_coarse.skip_connect_every", 3)
    assert cfg == base and "deprecated" in str(w[0].message)


@pytest.mark.parametrize("key", sorted(jschema.RENAMED_KEYS))
def test_renamed_keys_raise_as_jax(key):
    with pytest.raises(KeyError) as want:
        jschema._apply_override(jschema.Config(), key, 1)
    with pytest.raises(KeyError) as got:
        pschema._apply_override(pschema.Config(), key, 1)
    assert str(got.value) == str(want.value)


def test_registries_match_jax_and_register():
    assert pschema.DEPRECATED_KEYS == jschema.DEPRECATED_KEYS
    assert pschema.RENAMED_KEYS == jschema.RENAMED_KEYS
    with pytest.raises(ValueError):
        pschema.register_deprecated_key(
            "models.nerf_fine.skip_connect_every")
    with pytest.raises(ValueError):
        pschema.register_renamed_key("models.coarse", "x")
    with pytest.raises(KeyError, match="unknown config key"):
        pschema.load_config(CONFIGS[0], ["experiment.nope=1"])


def test_python_config(tmp_path):
    src = tmp_path / "c.py"
    src.write_text("cfg = {'experiment': {'id': 'py'}, 'optimizer': "
                   "{'lr': 0.5}}\n")
    got = pschema.load_config(src, ["dataset.image_size=64"])
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jschema.load_config(src, ["dataset.image_size=64"]))
    (tmp_path / "bad.py").write_text("x = 1\n")
    with pytest.raises(ValueError, match="'cfg'"):
        pschema.load_config(tmp_path / "bad.py")


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_dump_config_round_trips(path, tmp_path):
    cfg = pschema.load_config(path, OVERRIDES + ["experiment.id=1e-5",
                                                 "dataset.basedir=yes"])
    out = tmp_path / "config.yml"
    pschema.dump_config(cfg, out)
    text = out.read_text()
    want = dataclasses.asdict(cfg)
    want["models"]["nerf_coarse"]["skip_connect_ids"] = list(
        want["models"]["nerf_coarse"]["skip_connect_ids"])
    want["models"]["nerf_fine"]["skip_connect_ids"] = list(
        want["models"]["nerf_fine"]["skip_connect_ids"])
    assert yaml.safe_load(text) == want
    assert yaml_lite.safe_load(text) == want
    assert pschema.load_config(out) == cfg


def test_yaml_lite_dump_quotes_what_would_change_type():
    data = {"s": ["1e-5", "yes", "null", "", " pad", "a: b", "#x", "-y",
                  "2001-12-14", "x\ny", "it's", "0x10"],
            "f": [1e-05, 1e20, 0.1, -2.0, math.inf], "e": {}, "n": None,
            "b": False}
    text = yaml_lite.dump(data)
    for load in (yaml.safe_load, yaml_lite.safe_load):
        got = load(text)
        assert got == data


def test_srn_cars_code_is_the_whole_yaml():
    path = ROOT / "configs" / "srn-cars-code.yml"
    assert pschema.config_from_dict(pschema.SRN_CARS_CODE) == \
        pschema.load_config(path)
