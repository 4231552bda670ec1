"""The port's checkpoint stores (train/checkpoint.py) and its reader of
flax msgpack (train/flax_msgpack.py), against the JAX package's.

- a `.ckpt` that the JAX package's PickleStore saved from a small DG FCOS
  with Adam state loads into the port: parameters and moments equal
  `params_from_jax` exactly, the counts and meta come through, and the
  loaded model's forward agrees with JAX's to the parity tests' tolerance
  (rtol 1e-4, atol 1e-5, tests/test_torch_fcos_model.py); the next save
  writes the port's format; an SGD `.ckpt` gives the empty state;
- the reader gives what `flax.serialization.msgpack_restore` gives, for
  every type flax writes (bfloat16, numpy scalars, chunked leaves);
  chip_smoke.py's encoder writes the bytes flax writes, and its `.ckpt`
  writer the bytes PickleStore writes;
- `DirectoryStore`: `make_store` gives it for a directory; a round trip is
  exact; a tensor changed right after `save` does not reach the saved
  step; only the newest step is kept; a writer's error is raised at
  `wait`; an orbax directory of the JAX package raises.
"""

import os
import pickle

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_parity import build_fcos_pair, tiny_batch
from dgod_tpu.models.backbone import FCOSBackbone as JaxFCOSBackbone
from dgod_tpu.models.dg_fcos import IMAGENET_MEAN, IMAGENET_STD
from dgod_tpu.train import checkpoint as j_checkpoint
from dgod_tpu.train import optim as j_optim
from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
from dgod_tpu_torch.train import flax_msgpack
from dgod_tpu_torch.train import optim as t_optim
from dgod_tpu_torch.train.checkpoint import (CheckpointStore, DirectoryStore,
                                             make_store)
from dgod_tpu_torch.utils.weights import params_from_jax


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    return build_fcos_pair(seed=0)


def test_jax_ckpt_loads_into_the_port(tmp_path, pair):
    jm, jp, tm = pair
    rng = np.random.RandomState(0)
    opt = j_optim.init_opt_state(jp, j_optim.OptConfig("adam"))
    opt = {"mu": jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                              opt["mu"]),
           "nu": jax.tree.map(lambda x: rng.rand(*x.shape).astype(np.float32),
                              opt["nu"]),
           "count": jax.tree.map(lambda x: jnp.int32(rng.randint(1, 99)),
                                 opt["count"])}
    path = str(tmp_path / "jax.ckpt")
    j_checkpoint.PickleStore(path).save(
        3, jp, opt, {"val_acc": np.float64(0.25), "epoch": 3})

    params, opt_state, meta = make_store(path).load_latest()
    want = params_from_jax(_np(jp))
    assert params.keys() == want.keys() == tm.state_dict().keys()
    for k, v in want.items():
        assert torch.equal(params[k], v), k
    names = set(dict(tm.named_parameters()))
    for moment in ("mu", "nu"):
        ref = params_from_jax(_np(opt[moment]))
        assert set(opt_state[moment]) == names
        for k in names:
            assert torch.equal(opt_state[moment][k], ref[k]), (moment, k)
    flat = {".".join(str(p.key) for p in path[:-1]) + "." + path[-1].key: v
            for path, v in jax.tree_util.tree_flatten_with_path(
                opt["count"])[0]}
    flat = {k.replace(".kernel", ".weight"): int(v) for k, v in flat.items()}
    assert opt_state["count"] == {k: flat[k] for k in names}
    assert meta == {"val_acc": 0.25, "epoch": 3, "step": 3}
    assert type(meta["val_acc"]) is float

    model = DGFCOSModel(num_classes=9, num_domains=2, canvas=(128, 256),
                        compute_dtype=torch.float32,
                        backbone_block_counts=(1, 1, 1, 1), device="cpu",
                        seed=7)
    model.load_state_dict(params)
    state = t_optim.init_opt_state(dict(model.named_parameters()),
                                   t_optim.OptConfig("adam"))
    assert {k: set(v) for k, v in state.items()} == {
        k: set(v) for k, v in opt_state.items()}
    x = tiny_batch(b=2)["image"].astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    j_feats, _ = jax.jit(JaxFCOSBackbone(
        dtype=jnp.float32, block_counts=(1, 1, 1, 1)).apply)(
        {"params": jp["detector"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        t_feats, _ = model.detector.features(torch.from_numpy(x))
    for a, b in zip(j_feats, t_feats):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)

    CheckpointStore(path).save(4, params, opt_state, dict(meta))
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"  # the port's own format from now on
    again, _, meta2 = CheckpointStore(path).load_latest()
    assert meta2["step"] == 4 and all(torch.equal(again[k], params[k])
                                      for k in params)


def test_jax_sgd_ckpt_gives_the_empty_state(tmp_path):
    rng = np.random.RandomState(1)
    tree = {"detector": {"conv": {"kernel": rng.randn(3, 3, 2, 4).astype(
                np.float32), "bias": rng.randn(4).astype(np.float32)},
                         "bn": {k: rng.rand(4).astype(np.float32)
                                for k in ("scale", "bias", "mean", "var")}},
            "image_da": {"fc": {"kernel": rng.randn(5, 2).astype(np.float32)}}}
    path = str(tmp_path / "sgd.ckpt")
    j_checkpoint.PickleStore(path).save(0, tree, {}, {"val_acc": 0.5})
    params, opt_state, meta = CheckpointStore(path).load_latest()
    want = params_from_jax(tree)
    assert params.keys() == want.keys()
    assert all(torch.equal(params[k], v) for k, v in want.items())
    assert params["detector.conv.weight"].shape == (4, 2, 3, 3)
    assert opt_state == {} and meta == {"val_acc": 0.5, "step": 0}


def _trees():
    rng = np.random.RandomState(2)
    return {
        "arrays": {"w": rng.randn(3, 4).astype(np.float32),
                   "i": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "b": rng.rand(5) > 0.5, "empty": np.zeros((0, 3)),
                   "d": rng.randn(2).astype(np.float64),
                   "u8": rng.randint(0, 255, 7).astype(np.uint8)},
        "scalars": {"count": np.int32(7), "lr": np.float32(0.5),
                    "x": np.float64(-2.25)},
        "python": {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32,
                            -1, -32, -33, -128, -129, -32768, -32769,
                            -2**31 - 1, 2**63 - 1],
                   "floats": [1.5, -0.0, float("inf")], "none": None,
                   "bools": [True, False], "str": "s" * 40,
                   "long_str": "t" * 300, "bytes": b"\x01" * 70000,
                   "nested": {str(i): i for i in range(20)}},
    }


def test_flax_msgpack_reads_what_flax_writes(monkeypatch):
    trees = _trees()
    trees["bf16"] = {"w": jnp.asarray(np.linspace(-3, 3, 9), jnp.bfloat16)}
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)  # chunk leaves > 64 bytes
    trees["chunked"] = {"big": np.arange(100, dtype=np.float32).reshape(4, 25)}
    for name, tree in trees.items():
        data = fs.msgpack_serialize(tree)
        got, ref = flax_msgpack.msgpack_restore(data), fs.msgpack_restore(data)
        for (p, a), (q, b) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(ref)[0]):
            assert p == q, name
            if isinstance(b, (np.ndarray, np.generic, jax.Array)):
                b = np.asarray(b, np.float32 if name == "bf16" else None)
                assert a.dtype == b.dtype and a.shape == b.shape, (name, p)
                np.testing.assert_array_equal(a, b)
            else:
                assert type(a) is type(b) and a == b, (name, p)
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.msgpack_restore(fs.msgpack_serialize({"c": 1j}))


def test_chip_smoke_writes_what_flax_and_the_jax_store_write(tmp_path, pair):
    for name, tree in _trees().items():
        assert chip_smoke.msgpack_pack(tree) == fs.msgpack_serialize(tree), \
            name
    _, jp, tm = pair
    tree = chip_smoke.jax_layout(tm.state_dict())
    sd = params_from_jax(tree)
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    flat = jax.tree_util.tree_flatten_with_path(_np(jp))[0]
    assert [p for p, _ in flat] == [
        p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    path = str(tmp_path / "j.ckpt")
    j_checkpoint.PickleStore(path).save(-1, tree, {}, {"val_acc": -1.0})
    with open(path, "rb") as f:
        assert f.read() == chip_smoke.jax_ckpt_bytes(
            tree, {}, {"val_acc": -1.0, "step": -1})


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"a.weight": torch.randn(3, 4, generator=g),
              "bn.mean": torch.randn(5, generator=g)}
    opt_state = t_optim.init_opt_state(params, t_optim.OptConfig("adam"))
    opt_state["mu"]["a.weight"].normal_(generator=g)
    opt_state["count"]["bn.mean"] = 7
    return params, opt_state


def test_directory_store_round_trip_is_exact(tmp_path):
    store = make_store(str(tmp_path / "run"))
    assert isinstance(store, DirectoryStore)
    assert not store.exists() and store.load_latest() is None
    params, opt_state = _state()
    meta = {"val_acc": -float("inf"), "epoch": 3}
    store.save(3, params, opt_state, meta)
    store.wait()
    assert store.exists()
    assert sorted(os.listdir(tmp_path / "run" / "3")) == ["meta.json",
                                                         "state.pt"]
    got_params, got_state, got_meta = make_store(str(tmp_path / "run")
                                                 ).load_latest()
    assert got_params.keys() == params.keys()
    assert all(torch.equal(got_params[k], v) for k, v in params.items())
    for k in ("mu", "nu"):
        assert all(torch.equal(got_state[k][n], v)
                   for n, v in opt_state[k].items())
    assert got_state["count"] == opt_state["count"]
    assert got_meta == dict(meta, step=3)


def test_directory_store_saves_a_snapshot_and_keeps_the_newest(tmp_path):
    store = DirectoryStore(str(tmp_path / "run"))
    params, opt_state = _state(1)
    before = {k: v.clone() for k, v in params.items()}
    store.save(1, params, opt_state, {"epoch": 1})
    for v in params.values():  # as the next optimizer step would
        v.add_(1.0)
    opt_state["count"]["bn.mean"] += 1
    got, got_state, _ = store.load_latest()  # waits for the writer
    assert all(torch.equal(got[k], v) for k, v in before.items())
    assert got_state["count"]["bn.mean"] == 7
    store.save(2, params, opt_state, {"epoch": 2})
    store.wait()
    assert sorted(os.listdir(tmp_path / "run")) == ["2"]
    got, _, meta = store.load_latest()
    assert meta["epoch"] == 2 and torch.equal(got["a.weight"],
                                              params["a.weight"])


def test_directory_store_raises_writer_errors_and_orbax(tmp_path):
    (tmp_path / "file").write_text("")
    store = DirectoryStore(str(tmp_path / "file" / "run"))
    store.save(0, *_state(), {})  # returns: the writer fails later
    with pytest.raises(RuntimeError, match="checkpoint write"):
        store.wait()
    store.wait()  # the error is raised once

    orbax = j_checkpoint.OrbaxStore(str(tmp_path / "orbax"))
    orbax.save(5, {"w": np.ones(3, np.float32)}, {}, {"val_acc": 0.5})
    orbax.wait()
    with pytest.raises(ValueError, match="orbax"):
        DirectoryStore(str(tmp_path / "orbax")).load_latest()
