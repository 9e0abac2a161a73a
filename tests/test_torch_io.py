"""The port's file formats against the JAX package's libraries, on the CPU:
flax msgpack checkpoints (`train/msgpack_io.py`), the target-free inverse
converter (`convert.state_dict_to_jax_params`) and the YAML codec of
config.yaml (`utils/config.py`, against PyYAML)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from __graft_entry__ import _flagship_config
from espnet_tpu.models.asr import ASRModel as JASRModel
from espnet_tpu.tasks.asr import ASRTask as JASRTask
from espnet_tpu.utils.config import dataclass_to_dict as jdataclass_to_dict
from espnet_tpu_torch.convert import (jax_params_to_state_dict,
                                      load_jax_params,
                                      state_dict_to_jax_params)
from espnet_tpu_torch.models.asr import ASRConfig, ASRModel
from espnet_tpu_torch.tasks.asr import ASRTask
from espnet_tpu_torch.train import msgpack_io
from espnet_tpu_torch.utils.config import (YAMLError, dataclass_from_dict,
                                           dataclass_to_dict, dumps_yaml,
                                           load_yaml, loads_yaml)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """PyTorch on one thread, and one for the subprocesses this file
    starts: the suite's xdist workers share the CPU, and a worker's extra
    threads oversubscribe it."""
    import os

    import torch as _torch

    n, env = _torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    _torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    _torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env

CONF = "egs/librispeech_100/conf/train_asr_conformer.yaml"


@pytest.fixture(scope="module")
def jax_tree():
    """A reduced JAX ASRModel's param tree (numpy leaves) and its global-MVN
    collection."""
    cfg = _flagship_config(normalize="global_mvn", d_model=32, d_ff=64,
                           num_heads=2, num_encoder_layers=1,
                           num_decoder_layers=1, decoder_d_ff=64)
    v = fnn.meta.unbox(JASRModel(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8000)), jnp.array([8000]),
        jnp.ones((1, 3), jnp.int32), jnp.array([3]), True))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32),
        v["params"])
    return params, jax.tree_util.tree_map(np.asarray, v["mvn"])


def _same_order(tree, like):
    """`tree` rebuilt in the key order of `like`."""
    if isinstance(like, dict):
        return {k: _same_order(tree[k], like[k]) for k in like}
    return tree


def _assert_trees_equal(got, want):
    fg, fw = msgpack_io.flatten(got), msgpack_io.flatten(want)
    assert set(fg) == set(fw)
    for k in fw:
        assert np.asarray(fg[k]).dtype == np.asarray(fw[k]).dtype, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


# ------------------------------------------------------------------ msgpack

def test_port_bytes_are_flax_bytes_in_the_same_key_order(jax_tree):
    params, _ = jax_tree
    assert msgpack_io.to_bytes(params) == serialization.to_bytes(params)
    mixed = {"a": np.float32(1.5), "b": 7, "c": -70000, "d": 2.5,
             "e": True, "f": None, "g": "x" * 40, "h": {},
             "i": np.arange(70000, dtype=np.int32),
             "j": np.zeros((0, 3), np.float16), "k": 2 ** 40}
    assert msgpack_io.to_bytes(mixed) == serialization.to_bytes(mixed)


def test_flax_restores_the_tree_the_port_built(jax_tree):
    params, _ = jax_tree
    model = load_jax_params(
        ASRModel(ASRConfig(vocab_size=32, d_model=32, num_heads=2, d_ff=64,
                           num_encoder_layers=1, num_decoder_layers=1,
                           decoder_d_ff=64, conformer_kernel_size=7,
                           normalize="utterance_mvn")), params)
    data = msgpack_io.to_bytes(state_dict_to_jax_params(model.state_dict()))
    _assert_trees_equal(serialization.msgpack_restore(data), params)


def test_port_reads_flax_bytes_chunked_arrays_included(jax_tree, monkeypatch):
    params, _ = jax_tree
    _assert_trees_equal(msgpack_io.restore(serialization.to_bytes(params)),
                        params)
    big = {"w": np.arange(70, dtype=np.float32).reshape(10, 7),
           "n": {"s": np.int64(3)}}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(
        {"w": big["w"].copy(), "n": dict(big["n"])})
    assert b"__msgpack_chunked_array__" in data
    _assert_trees_equal(msgpack_io.restore(data), big)


def test_port_writer_refuses_what_flax_would_chunk(monkeypatch):
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    with pytest.raises(ValueError, match="MAX_CHUNK_SIZE"):
        msgpack_io.to_bytes({"w": np.zeros(17, np.float32)})


# ------------------------------------------------------------------ convert

def test_inverse_converter_is_the_identity_on_the_jax_tree(jax_tree):
    params, mvn = jax_tree
    sd = jax_params_to_state_dict({"params": params, "mvn": mvn})
    assert "mvn.mean" in sd
    back = state_dict_to_jax_params(sd)
    _assert_trees_equal(back, params)
    # the same bytes as flax once the keys are in flax's order
    assert msgpack_io.to_bytes(_same_order(back, params)) == \
        serialization.to_bytes(params)


def test_inverse_converter_refuses_unknown_leaves():
    with pytest.raises(ValueError, match="unknown parameter leaf"):
        state_dict_to_jax_params({"a.running_mean": torch.zeros(3)})


# ------------------------------------------------------------------- config

def _non_default(klass):
    """An instance of `klass` with every field moved off its default."""
    out = {}
    for f in dataclasses.fields(klass):
        d = f.default
        if isinstance(d, bool):
            v = not d
        elif isinstance(d, int):
            v = d + 3
        elif isinstance(d, float):
            v = d * 0.5 + 1.0e-9
        elif isinstance(d, tuple):
            v = tuple(range(1, len(d) + 3))
        elif d is None:
            v = 7 if "int" in str(f.type) else "yes 1e-9: a # b"
        else:
            v = f"{d}-x: y, z" if d else "on"
        out[f.name] = v
    return klass(**out)


@pytest.mark.parametrize("section", ["run", "optim", "data", "model"])
@pytest.mark.parametrize("which", ["defaults", "non_default"])
def test_config_sections_round_trip_through_pyyaml(section, which):
    klass = ASRTask.sections[section]
    obj = klass() if which == "defaults" else _non_default(klass)
    tree = {section: dataclass_to_dict(obj)}
    text = dumps_yaml(tree)
    assert yaml.safe_load(text) == tree
    assert loads_yaml(yaml.safe_dump(tree, sort_keys=False)) == tree
    assert loads_yaml(yaml.safe_dump(tree, sort_keys=False, width=24)) == tree
    assert dataclass_from_dict(klass, loads_yaml(text)[section]) == \
        dataclass_from_dict(klass, tree[section])


def test_sections_mirror_the_jax_task():
    assert list(ASRTask.sections) == list(JASRTask.sections)
    for name, klass in ASRTask.sections.items():
        assert dataclass_to_dict(klass()) == \
            jdataclass_to_dict(JASRTask.sections[name]()), name


def test_librispeech_conf_reads_as_pyyaml_reads_it():
    with open(CONF, encoding="utf-8") as f:
        want = yaml.safe_load(f)
    assert load_yaml(CONF) == want
    assert "--optim.name adamw" in want["recipe"]["asr_args"]


@pytest.mark.parametrize("text", [
    "a: |\n  x\n  y\n\n  z\nb: 1\n",
    "a: >\n  x\n  y\n\n  z\n   more\n  w\nb: 1\n",
    "a: >-\n  x\n  y\n",
    "a: |+\n  x\n\n\nb: 2\n",
    "a: |2\n    x\n   y\n",
    "# c\na: 1 # c\nb:   # c\n  - 1  # x\n  - [1, 2,   # c\n     3]\n  -\n"
    "    k: v\n",
    "a:\n  - b: 1\n    c: 2\n  - d\nx: 'it''s'\ny: \"\\t\\x41\\u00e9\"\n",
    "a: {b: 1, c: [x, y], d: 'q', e: \"r\"}\n",
    "a: 1.0e-9\nb: 1e-9\nc: yes\nd: Off\ne: ~\nf:\ng: 0o7\nh: 017\n"
    "i: 0x_1f\nj: -.inf\nl: 1_000.5\nm: 3:25:45\nn: 13_15\n",
    "- a\n- b: c\n  d: e\n- - f\n  - g\n",
    "a: plain\n  continued\n\n  para\nb: 1\n",
    "a: 'single\n  folded\n\n  x'\nb: \"dbl\\\n  \\ cont\n  next\"\n",
], ids=lambda t: repr(t[:12]))
def test_codec_reads_as_pyyaml_reads(text):
    assert loads_yaml(text) == yaml.safe_load(text)


_WORDS = ["a", "yes", "No", "1e-9", "1.0e-9", "13_15", "0,27", "null", "~",
          "", " lead", "trail ", "a: b", "x #y", "#c", "unused — device",
          "tab\there", "line\nbreak", "q'uote", 'dq"x', "back\\slash",
          "-dash", "- item", "[x]", "{y}", "017", "0x1F", "1:30", ".5", "on",
          "=x", "?x", "é", "\U0001F600", "--run.x 1 --model.y 2 " * 8]


def _random_tree(rng, depth=0):
    kind = rng.randint(4 if depth < 3 else 1)
    if kind == 0:
        pick = rng.randint(5)
        if pick == 0:
            return _WORDS[rng.randint(len(_WORDS))]
        if pick == 1:
            return int(rng.randint(-10 ** 6, 10 ** 6))
        if pick == 2:
            return [0.0, 1e-9, 2e-3, 1e16, -3.5, 0.1, float("inf")][
                rng.randint(7)]
        if pick == 3:
            return [True, False, None][rng.randint(3)]
        return " ".join(_WORDS[rng.randint(20)]
                        for _ in range(rng.randint(1, 30)))
    if kind == 1:
        return [_random_tree(rng, depth + 1) for _ in range(rng.randint(5))]
    keys = ["k", "key two", "yes", "1", "model.x", "a_b", "0.5", "null"]
    return {keys[rng.randint(len(keys))] + str(i): _random_tree(rng, depth + 1)
            for i in range(rng.randint(5))}


def test_codec_against_pyyaml_on_random_trees():
    """Seeded random config trees (config-like keys, any values) both ways,
    with PyYAML's block and flow styles and line widths."""
    rng = np.random.RandomState(0)
    for _ in range(300):
        tree = {"root": _random_tree(rng)}
        assert yaml.safe_load(dumps_yaml(tree)) == \
            yaml.safe_load(yaml.safe_dump(tree, sort_keys=False))
        for kw in ({}, {"width": 20}, {"default_flow_style": True},
                   {"allow_unicode": True}):
            text = yaml.safe_dump(tree, sort_keys=False, **kw)
            assert repr(loads_yaml(text)) == repr(yaml.safe_load(text)), text


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 1\n", "--- \na: 1\n", "a: 2001-12-14\n",
    "? a\n: 1\n", "a: <<\n", "a: [b: 1]\n",
], ids=["anchor", "tag", "document", "timestamp", "complex_key", "merge",
        "flow_pair"])
def test_codec_raises_outside_its_subset(text):
    with pytest.raises(YAMLError):
        loads_yaml(text)
