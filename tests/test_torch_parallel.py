"""The port's multi-GPU training (dgod_tpu_torch/parallel/) on gloo ranks
of this CPU, against the JAX package's and against one process.

The ranks are fresh processes (scripts/rank_launch.py, a file store
under tmp_path, one intra-op thread each, every join bounded by 120 s)
that run tests/_torch_ranks.py and import no JAX. Three launches feed
all the tests: 2 ranks, 2 ranks for tensor parallelism, and 4 ranks.

- `parse_mesh_spec` takes the JAX spec forms and messages, and refuses a
  mesh that leaves ranks out; `param_sharding` splits dim 0 of the
  TP_PATTERNS layers only (JAX's last-axis rule);
- `reduce_active_grads` makes ONE all-reduce, means the active entries
  (a None gradient as zeros) and the scalars, and passes inactive ones
  through; gathers and broadcasts reach every rank;
- the DP fused pair (0,1) of full-depth DG FCOS (f32, 32x64) on 2 ranks
  equals JAX's `make_spmd_pair_step` on 2 virtual CPU devices from the
  same weights and batch (the setting of tests/test_sharding.py);
- `Trainer(mesh=data 2)` reproduces the one-process epoch (losses,
  parameters, the validation mAP), as tests/test_train_e2e.py holds
  JAX's;
- tensor parallelism (data=1,model=2 and data=2,model=2): every fused
  pair of a DG cycle (modes 0 to 4) of each family equals the unsharded
  cycle on the global batches, and the checkpoint, written by rank 0 with
  the full tensors, loads into a one-process model;
- a mesh Trainer takes rank 0's checkpoint on every rank (best_val,
  parameters, optimizer state), also where only rank 0 finds the file;
- `cli.main([... "--mesh", "auto"])` on 2 ranks gives the test mAP of the
  run without `--mesh`, and only rank 0 writes the `.ckpt`.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from dgod_tpu.models.dg_fcos import DGFCOSModel as JaxDGFCOS
from dgod_tpu.parallel import mesh as jax_mesh
from dgod_tpu.parallel.spmd import make_spmd_pair_step
from dgod_tpu.train import steps as j_steps
from dgod_tpu.train.optim import init_opt_state as j_init_opt_state
from dgod_tpu_torch import cli
from dgod_tpu_torch.parallel import mesh as mesh_lib
from dgod_tpu_torch.train.checkpoint import CheckpointStore
from dgod_tpu_torch.utils.weights import params_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from scripts.rank_launch import spawn  # noqa: E402

JOIN_S = 120.0


def jax_pair_inputs():
    """tests/test_sharding.py::test_spmd_pair_step_matches_single_device's
    model, weights and batch, and JAX's DP pair (0,1) on 2 devices."""
    devs = jax.devices("cpu")[:2]
    mesh = jax_mesh.make_mesh(devs)
    canvas = (32, 64)
    model = JaxDGFCOS(num_classes=9, num_domains=2, canvas=canvas,
                      compute_dtype=jnp.float32)
    with jax.default_device(devs[0]):
        params = model.init(jax.random.PRNGKey(0))
    opt_config, base_lr = j_steps.make_optimizer("FCOS")
    opt_state = j_init_opt_state(params, opt_config)
    rng = np.random.RandomState(0)
    b = 2
    boxes = np.zeros((b, 8, 4), np.float32)
    labels = np.zeros((b, 8), np.int32)
    valid = np.zeros((b, 8), bool)
    boxes[:, 0] = [4, 4, 28, 28]
    labels[:, 0] = 1
    valid[:, 0] = True
    batch = {
        "image": rng.randint(0, 255, (b, *canvas, 3), np.uint8),
        "boxes": boxes, "labels": labels, "gt_valid": valid,
        "domain": np.arange(b, dtype=np.int32) % 2,
        "image_size": np.tile(np.float32(canvas), (b, 1)),
        "scale_back": np.ones((b, 2), np.float32),
    }
    state = params_from_jax(jax.tree.map(np.asarray, params))
    from jax.sharding import NamedSharding, PartitionSpec as P

    pair = make_spmd_pair_step(model, 1, R.REG, opt_config, base_lr, params,
                               mesh)
    rep = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P("data"))
    p_sh = jax.device_put(params, jax.tree.map(lambda _: rep, params))
    o_sh = jax.device_put(opt_state, jax.tree.map(lambda _: rep, opt_state))
    b_sh = jax.device_put(batch, {k: data for k in batch})
    with jax.set_mesh(mesh):
        p_out, _, m_out = pair(p_sh, o_sh, b_sh, jax.random.PRNGKey(5),
                               jax.random.PRNGKey(6), 1.0)
    return ({"state": state, "batch": batch},
            {"loss": float(m_out["loss"]), "loss0": float(m_out["loss0"]),
             "params": params_from_jax(jax.tree.map(np.asarray, p_out))})


def write_cli_domains(root):
    """Domains a (train, val) and i (val) in the CLI's layout, 4 PNGs
    each, every image with one car box centred in x: a horizontal flip
    leaves it in place, so every image has the same foreground count and
    the DP loss equals the one-process loss."""
    from dgod_tpu_torch.data import png

    rng = np.random.RandomState(0)
    for letter, split in (("a", "train"), ("a", "val"), ("i", "val")):
        name, csv_tpl, root_tpl = cli.DOMAIN_SPECS[letter]
        img_root = os.path.join(root, root_tpl.format(split=split))
        os.makedirs(img_root, exist_ok=True)
        rows = []
        for i in range(4):
            fname = f"{name}_{split}_{i}.png"
            img = rng.randint(0, 255, (60, 120, 3)).astype(np.uint8)
            img[15:40, 40:80] = (250, 30, 30)
            png.write_png(os.path.join(img_root, fname), img)
            rows.append(f"{fname},40 15 80 40,3")
        csv_path = os.path.join(root, csv_tpl.format(split=split))
        os.makedirs(os.path.dirname(csv_path), exist_ok=True)
        with open(csv_path, "w") as f:
            f.write("image_name,BoxesString,LabelsString\n")
            f.write("\n".join(rows) + "\n")


def cli_argv(root, weights_folder):
    return ["--model", "FCOS", "--exp", "dg", "--source_domains", "A",
            "--target_domains", "I", "--max_epochs", "1",
            "--batch_size", "4", "--eval_batch_size", "2",
            "--data_root", root, "--weights_folder", weights_folder,
            "--weights_file", "t"]


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, one_thread):
    root = str(tmp_path_factory.mktemp("two_ranks"))
    inputs, jax_out = jax_pair_inputs()
    inputs_path = os.path.join(root, "jax_inputs.pt")
    torch.save(inputs, inputs_path)
    write_cli_domains(root)
    argv = cli_argv(root, os.path.join(root, "w_mesh"))
    ranks = spawn(R.two_rank_checks, 2, (root, inputs_path, argv),
                  store_dir=os.path.join(root, "ranks"), device="cpu",
                  timeout=JOIN_S)
    os.remove(inputs_path)  # a full-depth model's weights
    return {"root": root, "ranks": ranks, "jax": jax_out}


@pytest.fixture(scope="module")
def tp_two_ranks(tmp_path_factory, one_thread):
    root = str(tmp_path_factory.mktemp("tp_two_ranks"))
    ranks = spawn(R.tp_two_rank_checks, 2, (root,),
                  store_dir=os.path.join(root, "ranks"), device="cpu",
                  timeout=JOIN_S)
    return {"root": root, "ranks": ranks}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, one_thread):
    root = str(tmp_path_factory.mktemp("four_ranks"))
    ranks = spawn(R.four_rank_checks, 4, (root,),
                  store_dir=os.path.join(root, "ranks"), device="cpu",
                  timeout=JOIN_S)
    return {"root": root, "ranks": ranks}


def test_parse_mesh_spec():
    assert mesh_lib.parse_mesh_spec("auto", 8).shape == {"data": 8,
                                                        "model": 1}
    assert mesh_lib.parse_mesh_spec("data=4,model=2", 8).shape == {
        "data": 4, "model": 2}
    assert mesh_lib.parse_mesh_spec("model=2", 8).shape == {"data": 4,
                                                           "model": 2}
    assert mesh_lib.parse_mesh_spec("data=8", 8).shape == {"data": 8,
                                                          "model": 1}
    with pytest.raises(ValueError, match="needs 16 devices"):
        mesh_lib.parse_mesh_spec("data=16", 8)
    with pytest.raises(ValueError, match="bad --mesh spec"):
        mesh_lib.parse_mesh_spec("tp=4", 8)
    # unlike a JAX mesh, the mesh must hold every rank
    with pytest.raises(ValueError, match="uses 4 of 8 ranks"):
        mesh_lib.parse_mesh_spec("data=4", 8)
    with pytest.raises(ValueError, match="uses 6 of 8 ranks"):
        mesh_lib.parse_mesh_spec("model=3", 8)


def test_row_blocks_split_a_host_batch():
    mesh = mesh_lib.parse_mesh_spec("data=4", 4)
    assert mesh.row_block(8) == (0, 2)  # rank 0's rows
    rows = mesh_lib.batch_rows({"image": np.arange(8), "num_real": 1}, mesh)
    np.testing.assert_array_equal(rows["image"], np.arange(2))
    assert rows["num_real"] == 1  # the tail's one real image is rank 0's
    with pytest.raises(ValueError, match="not divisible"):
        mesh.row_block(6)


def test_param_sharding_tp_rule():
    from dgod_tpu_torch.models.layers import Conv, Dense

    model = torch.nn.Module()
    model.head = torch.nn.Module()
    model.head.cls_conv0 = Conv(256, 256, 3)
    model.head.cls_logits = Conv(256, 9, 3)
    model.box_head = torch.nn.Module()
    model.box_head.fc7 = Dense(1024, 1024)
    model.box_head.odd = Dense(4, 3)  # 3 rows do not split over 2
    model.backbone = torch.nn.Module()
    model.backbone.conv1 = Conv(3, 64, 7)
    sharding = mesh_lib.param_sharding(model,
                                       mesh_lib.parse_mesh_spec("model=2", 2))
    assert sharding == {"head.cls_conv0.weight": 0, "head.cls_conv0.bias": 0,
                        "box_head.fc7.weight": 0, "box_head.fc7.bias": 0}
    assert mesh_lib.param_sharding(
        model, mesh_lib.parse_mesh_spec("auto", 2)) == {}


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_active_grads_reduces_only_active(two_ranks, four_ranks,
                                                 world):
    ranks = (two_ranks if world == 2 else four_ranks)["ranks"]
    for r, got in enumerate(ranks):
        g = got["group"]
        assert g["all_reduces"] == 1  # gradients and scalars: one buffer
        np.testing.assert_allclose(g["a"], g["g_a"].mean(0), rtol=1e-6)
        np.testing.assert_array_equal(g["b"], g["g_b"][r])  # untouched
        np.testing.assert_array_equal(g["c"], np.zeros((2, 2), np.float32))
        assert g["loss"] == pytest.approx(np.mean(range(world)))
        np.testing.assert_array_equal(g["gathered"]["rank"],
                                      np.arange(world))
        np.testing.assert_array_equal(
            g["gathered"]["rows"][0],
            np.repeat(np.arange(world)[:, None], 3, 1))
        np.testing.assert_array_equal(g["weight"], ranks[0]["group"]["weight"])


def test_dp_pair_step_matches_jax_spmd(two_ranks):
    """Loss rtol 1e-4, parameters rtol 5e-3 / atol 1e-4, as JAX's own
    SPMD test holds its pair step."""
    ref = two_ranks["jax"]
    for got in (r["jax_pair"] for r in two_ranks["ranks"]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["loss0"], ref["loss0"], rtol=1e-4)
    params = two_ranks["ranks"][0]["jax_pair"]["params"]
    for name, v in params.items():
        np.testing.assert_allclose(v, ref["params"][name].numpy(),
                                   rtol=5e-3, atol=1e-4, err_msg=name)


def test_trainer_mesh_dp_matches_single_device(two_ranks, tmp_path,
                                               monkeypatch):
    R.patch_canvas(monkeypatch.setattr, (32, 64), (30, 60))
    single = R.epoch_result(R.fixed_box_trainer(str(tmp_path)))
    # 32 images / global batch 8 = 4 pair steps: all four DG pairs ran
    assert single["step"] == 8
    for got in [single] + [r["dp"] for r in two_ranks["ranks"]]:
        # the host's wait for batches is a part of the epoch's wall time
        assert 0 <= got["loader_wait_s"] <= got["epoch_s"]
    for got in (r["dp"] for r in two_ranks["ranks"]):
        assert got["step"] == 8
        np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["loss0"], single["loss0"], rtol=1e-4)
        assert got["map"] == single["map"]
    for name, v in two_ranks["ranks"][0]["dp"]["params"].items():
        np.testing.assert_allclose(v, single["params"][name], rtol=5e-3,
                                   atol=3e-4, err_msg=name)


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory, one_thread):
    """Each family's step in one process, on the whole batch."""
    root = str(tmp_path_factory.mktemp("unsharded"))
    out = {}
    for family in ("FCOS", "FRCNN"):
        t = R.tp_trainer(family, root)
        t.train_epoch()
        out[family] = {"losses": t.pair_losses,
                       "params": R.numpy_params(t.model)}
    return out


@pytest.mark.parametrize("spec", ["data=1,model=2", "data=2,model=2"])
@pytest.mark.parametrize("family", ["FCOS", "FRCNN"])
def test_tensor_parallel_matches_unsharded_step(tp_two_ranks, four_ranks,
                                                unsharded, spec, family):
    run = tp_two_ranks if spec == "data=1,model=2" else four_ranks
    ref = unsharded[family]
    patterns = ("head.cls_conv", "head.reg_conv") if family == "FCOS" \
        else ("box_head.fc6", "box_head.fc7")
    for got in (r["tp"][family] for r in run["ranks"]):
        assert got["sharded"] and all(any(p in n for p in patterns)
                                      for n in got["sharded"])
        assert (got["local_shape"][0] * 2
                == ref["params"][got["sharded"][0]].shape[0])
        # the four pairs (0,1)..(0,4): [loss0, loss] of each
        assert len(got["losses"]) == 4
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    full = run["ranks"][0]["tp"][family]["params"]
    for name, p in ref["params"].items():
        np.testing.assert_allclose(full[name], p, rtol=5e-3, atol=1e-4,
                                   err_msg=name)
    # rank 0's checkpoint holds the full tensors: it loads into one process
    path = os.path.join(run["root"], f"tp_{family}.ckpt")
    params, _, meta = CheckpointStore(path).load_latest()
    os.remove(path)
    model = R.tp_model(family)
    model.load_state_dict(params)
    for name, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), full[name], err_msg=name)
    assert meta["val_acc"] == 0.5


def test_mesh_checkpoint_comes_from_rank_0(tp_two_ranks):
    """Rank 1 finds no file (nodes that do not share the weights folder),
    yet holds rank 0's best_val, parameters and optimizer state."""
    ranks = [r["ckpt"] for r in tp_two_ranks["ranks"]]
    assert [r["best_val"] for r in ranks] == [0.5, 0.5]
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_cli_mesh_auto_matches_one_process(two_ranks, monkeypatch,
                                           one_thread):
    root = two_ranks["root"]
    R.patch_small_cli(monkeypatch.setattr)
    want = cli.main(cli_argv(root, os.path.join(root, "w_single")),
                    device="cpu")
    got = [r["cli"] for r in two_ranks["ranks"]]
    for g in got:
        assert g["map"] == want["map_50"]
        np.testing.assert_array_equal(g["per_class"], want["map_per_class"])
    assert got[0]["saves"] >= 1 and got[1]["saves"] == 0
    assert os.listdir(os.path.join(root, "w_mesh")) == ["t.ckpt"]
    for folder in ("w_mesh", "w_single"):
        os.remove(os.path.join(root, folder, "t.ckpt"))
