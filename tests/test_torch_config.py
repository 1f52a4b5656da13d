"""The port's configuration tree and YAML reader against the JAX package (CPU).

``prior_diffuse_tpu_torch.config.read_yaml`` reads the subset of YAML that
``conf/*.yml`` use (the machine with the GPU has no PyYAML): it must give
what ``yaml.safe_load`` gives on every file there, and raise on what it
does not cover.  ``load_experiment`` must build the same tree as the JAX
one (``dataclasses.asdict``), and every dataclass must carry the same
fields and defaults.
"""

import dataclasses
import glob
import os

import pytest
import yaml

import prior_diffuse_tpu.config as jcfg
from prior_diffuse_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(ROOT, "conf", "*.yml")))
CLASSES = ["StftConfig", "TrainConfig", "ModelConfig", "OptimConfig",
           "DiffusionConfig", "ExperimentConfig", "RunConfig"]


def test_all_four_confs_are_covered():
    assert [os.path.basename(p) for p in CONFS] == [
        "dbaiat.yml", "diff.yml", "gcrn.yml", "grn.yml"]


@pytest.mark.parametrize("path", CONFS, ids=os.path.basename)
def test_read_yaml_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    got, want = tcfg.read_yaml(text), yaml.safe_load(text)
    assert got == want
    # same types, not just equal values (1 == 1.0 == True in Python)
    flat = lambda d: [(k, type(v)) for k, v in sorted(d.items())]
    assert flat(got) == flat(want)
    for key, value in want.items():
        if isinstance(value, dict):
            assert flat(got[key]) == flat(value), key


@pytest.mark.parametrize("path", CONFS, ids=os.path.basename)
def test_load_experiment_equals_jax(path):
    got = dataclasses.asdict(tcfg.load_experiment(path))
    want = dataclasses.asdict(jcfg.load_experiment(path))
    assert got == want


def test_read_yaml_scalars_equal_safe_load():
    text = "\n".join([
        "# a comment line",
        "top: 3",
        "sec:",
        "  a: 'quoted # not a comment'   # a comment",
        '  b: "double"',
        "  c: bare_word",
        "  d: 0.0000001",
        "  e: -2",
        "  f: 1.5e-3",
        "  g: false",
        "  h: True",
        "  i: .5",
        "empty:",
        "other:",
        "    deep_indent: 7",
    ])
    assert tcfg.read_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, 2]",            # flow sequence
    "a: {b: 1}",            # flow mapping
    "a:\n  - 1",            # block sequence
    "a:\n  b:\n    c: 1",   # a third level
    "a: &x 1",              # anchor
    "a: yes",               # a YAML 1.1 boolean word
    "a: 1e-7",              # a string in YAML 1.1, a float elsewhere
    "a: 010",               # octal in YAML 1.1
    "a:\n\tb: 1",           # tab indentation
    "a: 'x",                # unterminated quote
    "a: 1\na: 2",           # duplicate key
    "a:\n  b: 1\n   c: 2",  # inconsistent indentation
    "  a: 1",               # indented first key
])
def test_read_yaml_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        tcfg.read_yaml(text)


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_equal_jax(name):
    t_cls, j_cls = getattr(tcfg, name), getattr(jcfg, name)
    t_fields = [f.name for f in dataclasses.fields(t_cls)]
    assert t_fields == [f.name for f in dataclasses.fields(j_cls)]
    assert dataclasses.asdict(t_cls()) == dataclasses.asdict(j_cls())


def test_run_config_paths_equal_jax():
    kw = dict(assets="a", doc="d")
    for prop in ("log_dir", "checkpoint_dir", "generated_wav_dir"):
        assert getattr(tcfg.RunConfig(**kw), prop) == getattr(jcfg.RunConfig(**kw), prop)
    train_t, train_j = tcfg.TrainConfig(), jcfg.TrainConfig()
    assert train_t.freq_bins == train_j.freq_bins == 161
    assert dataclasses.asdict(train_t.stft) == dataclasses.asdict(train_j.stft)
    assert tcfg.DiffusionConfig().num_steps == jcfg.DiffusionConfig().num_steps


def test_experiment_from_dict_ignores_unknown_keys():
    raw = {"train": {"batch_size": 2, "no_such": 1}, "no_such_section": {"x": 1},
           "diffusion": {"predict": "x0", "x0_leak_drop": 1.0}}
    got = dataclasses.asdict(tcfg.experiment_from_dict(raw))
    assert got == dataclasses.asdict(jcfg.experiment_from_dict(raw))
    assert got["train"]["batch_size"] == 2
