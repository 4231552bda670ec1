"""What the ranks of tests/test_torch_parallel.py run: module-level
functions for `scripts/rank_launch.spawn`, which pickles them by name
into fresh gloo ranks. This module imports torch, numpy and
dgod_tpu_torch only: the ranks load no JAX (the test process hands them
the JAX side's numbers through files).

Each rank function returns a dict of numpy values; the parameters only
from rank 0 (every rank holds the same ones).
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from dgod_tpu_torch.data import transforms as T
from dgod_tpu_torch.data.dataset import ConcatDataset
from dgod_tpu_torch.data.loader import EvalLoader, TrainLoader
from dgod_tpu_torch.models import dg_fcos, dg_frcnn
from dgod_tpu_torch.models.dg_frcnn import batch_to_torch
from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig
from dgod_tpu_torch.parallel import mesh as mesh_lib
from dgod_tpu_torch.parallel import multihost, spmd
from dgod_tpu_torch.parallel.tensor_parallel import gather_state
from dgod_tpu_torch.train import steps as step_lib
from dgod_tpu_torch.train.checkpoint import CheckpointStore
from dgod_tpu_torch.train.harness import Trainer
from dgod_tpu_torch.train.optim import init_opt_state
from dgod_tpu_torch.utils.synthetic import HostBatches, synthetic_batch

REG = (0.5, 0.5, 0.5, 0.05, 1e-4)
SMALL_FRCNN = FRCNNConfig(rpn_pre_nms_train=256, rpn_pre_nms_test=256,
                          rpn_post_nms_train=256, rpn_post_nms_test=256,
                          rpn_batch_per_image=64, box_batch_per_image=64)
TP_CANVAS = (32, 64)


def numpy_params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def patch_canvas(set_attr, canvas, train_size):
    """The data pipeline at a small canvas (`set_attr`: setattr in a rank,
    monkeypatch.setattr in the test process)."""
    set_attr(T, "CANVAS", canvas)
    set_attr(T, "TRAIN_SIZE", train_size)
    set_attr(T, "MIN_SIZE", train_size[0])
    set_attr(T, "MAX_SIZE", train_size[1])
    set_attr(T, "MIN_AREA", 1.0)


def patch_small_cli(set_attr):
    """The CLI's models at the reduced depth, float32, 64x128 canvas (as
    tests/test_torch_cli.py's `small` fixture)."""
    patch_canvas(set_attr, (64, 128), (60, 120))
    small = dict(backbone_block_counts=(1, 1, 1, 1),
                 compute_dtype=torch.float32)
    frcnn, fcos = dg_frcnn.DGFRCNNModel, dg_fcos.DGFCOSModel
    set_attr(dg_frcnn, "DGFRCNNModel",
             lambda **kw: frcnn(config=SMALL_FRCNN, **small, **kw))
    set_attr(dg_fcos, "DGFCOSModel", lambda **kw: fcos(**small, **kw))


class FixedBoxDataset:
    """Every image holds ONE identical box, so every image has the same
    foreground count: per-rank loss normalisation then equals the global
    one (as the JAX package's tests/test_train_e2e.py arranges)."""

    def __init__(self, n, domain, seed=0, image_hw=(30, 60)):
        rng = np.random.RandomState(seed + domain)
        self.images = [rng.randint(0, 255, (*image_hw, 3), np.uint8)
                       for _ in range(n)]
        self.domain = domain

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return (self.images[idx].copy(),
                np.array([[6.0, 6.0, 30.0, 26.0]], np.float32),
                np.array([1], np.int32), self.domain)


def fixed_box_trainer(root, mesh=None):
    """The JAX test_trainer_mesh_dp_matches_single_device setting: DG
    FCOS (block counts (1,1,1,1), f32) on 32 fixed-box images in batches
    of 8, validation on 4 in batches of 2, at the 32x64 canvas (the
    caller patches it)."""
    train = ConcatDataset([FixedBoxDataset(16, 0), FixedBoxDataset(16, 1)])
    model = dg_fcos.DGFCOSModel(num_classes=9, num_domains=2,
                                canvas=(32, 64), compute_dtype=torch.float32,
                                backbone_block_counts=(1, 1, 1, 1),
                                device="cpu")
    name = "single" if mesh is None else f"mesh{multihost.rank()}"
    return Trainer(model, TrainLoader(train, 8, dg=True, num_workers=2,
                                      max_gt=4),
                   EvalLoader(FixedBoxDataset(4, 0, seed=7), 2, True,
                              num_workers=2, max_gt=4),
                   dg=True, max_epochs=1, log_every=1,
                   ckpt_path=os.path.join(root, f"{name}.ckpt"),
                   device="cpu", mesh=mesh)


def epoch_result(trainer):
    t0 = time.perf_counter()
    stats = trainer.train_epoch()
    epoch_s = time.perf_counter() - t0
    val = trainer.validate()
    return {"step": trainer.global_step, "loss": stats["loss"],
            "loss0": stats["loss0"], "map": val["map_50"],
            "images_per_sec": stats["images_per_sec"],
            "loader_wait_s": stats["loader_wait_s"], "epoch_s": epoch_s,
            "params": numpy_params(trainer.model)}


def tp_batches():
    """One DG cycle's host batches: 4 of 4 images with 2-8 boxes each, 2
    domains."""
    rng = np.random.RandomState(3)
    return [synthetic_batch(rng, 4, TP_CANVAS, 2, max_gt=8)
            for _ in range(4)]


def tp_model(family):
    """The family's model at TP_CANVAS, block counts (1,1,1,1), f32, from
    seed 0."""
    kw = dict(num_classes=9, num_domains=2, canvas=TP_CANVAS,
              compute_dtype=torch.float32, backbone_block_counts=(1, 1, 1, 1),
              device="cpu", seed=0)
    if family == "FCOS":
        return dg_fcos.DGFCOSModel(**kw)
    return dg_frcnn.DGFRCNNModel(config=SMALL_FRCNN, **kw)


def tp_trainer(family, root, mesh=None):
    """The family's DG cycle (the fused pairs (0,1) to (0,4), one of
    `tp_batches()` each); every pair's [loss0, loss] is kept in
    `trainer.pair_losses`."""
    name = "single" if mesh is None else "tp"
    t = Trainer(tp_model(family), HostBatches(tp_batches(), True), None,
                dg=True, log_every=10 ** 9, seed=5, device="cpu", mesh=mesh,
                ckpt_path=os.path.join(root, f"{name}_{family}.ckpt"))
    t.pair_losses = []
    for k, step in t.pair_steps.items():
        def logged(*a, _step=step):
            opt_state, metrics = _step(*a)
            t.pair_losses.append([float(metrics["loss0"]),
                                  float(metrics["loss"])])
            return opt_state, metrics
        t.pair_steps[k] = logged
    return t


def tp_checks(root, spec):
    """Each family's DG cycle under `spec`, its checkpoint written, and
    the gathered parameters."""
    out = {}
    for family in ("FCOS", "FRCNN"):
        mesh = mesh_lib.parse_mesh_spec(spec)
        t = tp_trainer(family, root, mesh)
        t.train_epoch()
        full = gather_state(t.model.state_dict(), t.sharding, mesh)
        t._save_checkpoint(0, 0.5)
        out[family] = {
            "losses": t.pair_losses,
            "sharded": sorted(t.sharding),
            "local_shape": tuple(t.model.state_dict()[
                sorted(t.sharding)[0]].shape),
            "params": {k: v.numpy().copy() for k, v in full.items()}
            if multihost.rank() == 0 else None}
    return out


def group_checks():
    """reduce_active_grads (one all-reduce, inactive entries untouched, a
    None gradient as zeros), all_gather_host_arrays and broadcast_module
    on this group."""
    r, w = dist.get_rank(), dist.get_world_size()
    rng = np.random.RandomState(0)
    g_a = rng.rand(w, 6).astype(np.float32)  # row r: rank r's gradient
    g_b = rng.rand(w, 3).astype(np.float32)
    grads = {"a": torch.from_numpy(g_a[r]), "b": torch.from_numpy(g_b[r]),
             "c": None}
    like = {"a": torch.zeros(6), "b": torch.zeros(3), "c": torch.ones(2, 2)}
    active = {"a": True, "b": False, "c": True}
    calls = []
    all_reduce = dist.all_reduce
    dist.all_reduce = lambda *a, **k: calls.append(1) or all_reduce(*a, **k)
    try:
        out, scalars = spmd.reduce_active_grads(
            grads, active, {"loss": torch.tensor(float(r))}, like=like)
    finally:
        dist.all_reduce = all_reduce
    gathered = multihost.all_gather_host_arrays(
        {"rank": np.asarray(r), "rows": (np.full(3, r),)})
    torch.manual_seed(r)
    layer = torch.nn.Linear(3, 2)
    multihost.broadcast_module(layer)
    return {"a": out["a"].numpy(), "b": out["b"].numpy(),
            "c": out["c"].numpy(), "loss": float(scalars["loss"]),
            "all_reduces": len(calls), "g_a": g_a, "g_b": g_b,
            "gathered": gathered, "weight": layer.weight.detach().numpy()}


def jax_parity_pair(inputs_path):
    """The DP fused pair (0,1) of full-depth DG FCOS (f32, 32x64) from the
    JAX package's weights on this rank's rows of the JAX test's batch."""
    inp = torch.load(inputs_path, weights_only=False)
    model = dg_fcos.DGFCOSModel(num_classes=9, num_domains=2,
                                canvas=(32, 64), compute_dtype=torch.float32,
                                device="cpu")
    model.load_state_dict(inp["state"])
    mesh = mesh_lib.make_mesh()
    opt_config, lr = step_lib.make_optimizer("FCOS")
    opt_state = init_opt_state(dict(model.named_parameters()), opt_config)
    step = step_lib.make_pair_step(model, 1, REG, opt_config, lr, mesh=mesh)
    batch = batch_to_torch(mesh_lib.batch_rows(inp["batch"], mesh), "cpu")
    _, metrics = step(opt_state, batch, None, None, 1.0)
    return {"loss": float(metrics["loss"]), "loss0": float(metrics["loss0"]),
            "params": numpy_params(model) if dist.get_rank() == 0 else None}


def checkpoint_from_rank_0(root):
    """A mesh Trainer whose rank 0 alone finds a checkpoint (rank 0's TP
    FCOS cycle's, val_acc 0.5), as on nodes that do not share the weights
    folder: every rank must take rank 0's. -> its best_val and a digest of
    its parameters and optimizer state."""
    path = os.path.join(root, "tp_FCOS.ckpt" if dist.get_rank() == 0
                        else "absent.ckpt")
    t = Trainer(tp_model("FCOS"), HostBatches(tp_batches(), True), None,
                dg=True, device="cpu", mesh=mesh_lib.parse_mesh_spec("auto"),
                ckpt_path=path)
    state = [p.detach() for p in t.model.parameters()]
    state += [v for k in ("mu", "nu") for v in t.opt_state[k].values()]
    return {"best_val": t.best_val, "digest": hashlib.sha256(torch.cat(
        [v.reshape(-1) for v in state]).numpy().tobytes()).hexdigest()}


def two_rank_checks(root, inputs_path, cli_argv):
    """The 2-rank tests' numbers but tensor parallelism's, in one launch."""
    out = {"group": group_checks(),
           "jax_pair": jax_parity_pair(inputs_path)}
    patch_canvas(setattr, (32, 64), (30, 60))
    out["dp"] = epoch_result(fixed_box_trainer(root, mesh_lib.parse_mesh_spec(
        "auto")))
    from dgod_tpu_torch import cli

    patch_small_cli(setattr)
    saves = []
    save = CheckpointStore.save
    CheckpointStore.save = lambda *a, **k: saves.append(1) or save(*a, **k)
    try:
        result = cli.main(cli_argv + ["--mesh", "auto"], device="cpu")
    finally:
        CheckpointStore.save = save
    out["cli"] = {"map": result["map_50"],
                  "per_class": np.asarray(result["map_per_class"]),
                  "saves": len(saves)}
    return out


def tp_two_rank_checks(root):
    """Tensor parallelism over data=1, model=2, then a mesh Trainer
    warm-started from the checkpoint it wrote (a launch of its own: each
    launch's join is bounded)."""
    return {"tp": tp_checks(root, "data=1,model=2"),
            "ckpt": checkpoint_from_rank_0(root)}


def four_rank_checks(root):
    """The 4-rank tests' numbers: the group checks, and tensor
    parallelism over data=2, model=2 (global-batch semantics)."""
    return {"group": group_checks(), "tp": tp_checks(root, "data=2,model=2")}
