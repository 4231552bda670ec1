"""Training harness — epoch loop, validation mAP, checkpointing, early stop
(port of dgod_tpu/train/harness.py, one device).

Replaces the reference's PyTorch-Lightning Trainer usage
(train_driving_dg.py:160-168) with an explicit loop:
- per-epoch reshuffled train loader with the DG duplicate-batch sampler;
  under fused pairs (the default in 'dg') each batch runs mode 0 then mode
  k in one pair step and the loader's duplicate emission is switched off,
- 5-mode schedule via ModeScheduler (mode state persists across epochs,
  like the reference's `self.mode` attribute),
- validation mAP@0.5 every epoch -> drives ReduceLROnPlateau (factor 0.1,
  patience 5), ModelCheckpoint(best val_acc), EarlyStopping(patience 10)
  (train_driving_dg.py:160-163, DGFRCNN.py:105),
- warm start from an existing checkpoint (train_driving_dg.py:154-155),
  else, given `torch_weights`, from a torchvision checkpoint (the
  reference's COCO / ImageNet init, fasterrcnn.py:320-322, fcos.py:776-783),
- `test()` = one validation sweep over the target domain with the best
  checkpoint reloaded, the reference's 0-epoch-fit quirk
  (train_driving_dg.py:166-168).

The sampling priorities of the FRCNN losses come from `model.make_draws`
with a `torch.Generator` on the device, seeded from `seed`.

Scale-out (`mesh=` / CLI `--mesh`, one process per card as torchrun
launches them; parallel/): the reference is single-GPU with hard-coded
`.cuda()` (train_driving_dg.py:163, SURVEY §2c); here the same Trainer
drives a data x model mesh of ranks:

- the device is this rank's card; the parameters are broadcast from rank 0
  after init (and after a warm start), then, with a model axis > 1, the
  head layers are split over it (parallel/tensor_parallel.py);
- each rank's loaders yield its row block of every host batch
  (`Mesh.row_block`), and the steps, built with the mesh, make one fused
  all-reduce of the active gradients and the loss scalars per step half
  (parallel/spmd.py), so the logged losses are the reduced ones;
- `validate()` harvests this rank's images, then gathers the per-image
  arrays of all ranks once, so every rank computes the same mAP (and
  takes the same plateau, early-stopping and checkpoint decisions);
- the checkpoint holds the full tensors (split ones gathered) and rank 0
  alone writes it: the file a one-device run writes.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ..data.loader import device_prefetch, to_tensor
from ..device import resolve_device
from ..eval import MeanAveragePrecision
from ..parallel import multihost, spmd
from ..parallel.tensor_parallel import gather_state, shard_model, shard_state
from ..utils import weights as weights_lib
from ..utils.logging import MetricsLogger, span
from . import steps as step_lib
from .checkpoint import make_store, tree_to
from .optim import EarlyStopping, ReduceLROnPlateau, init_opt_state

_DET_KEYS = ("boxes", "scores", "labels", "valid")


class Trainer:
    """Fit, validate and test one model on one device, or on this rank's
    card of a `mesh` (parallel/mesh.py). `device=None` means the card
    (raises without CUDA); the model is moved there."""

    def __init__(
        self,
        model,
        train_loader,
        val_loader,
        reg_weights=(0.5, 0.5, 0.5, 0.05, 1e-4),
        dg: bool = True,
        max_epochs: int = 100,
        ckpt_path: str = "checkpoints/model.ckpt",
        seed: int = 42,
        log_every: int = 50,
        metrics_path: str = None,
        tb_dir: str = None,
        warmup_steps: int = 0,
        fused_pairs: bool = True,
        torch_weights: str = None,
        device=None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mesh = mesh
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.reg_weights = tuple(reg_weights)
        self.dg = dg
        self.max_epochs = max_epochs
        self.ckpt_path = ckpt_path
        self.log_every = log_every
        # rank 0 alone logs and prints: every rank holds the same numbers
        self.is_main = multihost.rank() == 0
        self.metrics = MetricsLogger(metrics_path if self.is_main else None,
                                     tb_dir=tb_dir if self.is_main else None)
        # linear LR warmup for from-scratch runs; 0 (default) is the
        # reference's behaviour (it always warm-starts COCO weights)
        self.warmup_steps = warmup_steps
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.store = make_store(ckpt_path)
        # a checkpoint to resume from overwrites every tensor anyway
        backbone = model.detector.backbone
        if torch_weights and not backbone.torchvision_weights:
            raise ValueError(f"--torch_weights ports torchvision's ResNet-50 "
                             f"detectors; {type(backbone).__name__} has none")
        if torch_weights and not self.store.exists():
            sd = weights_lib.load_torch_file(torch_weights)
            family = weights_lib.torchvision_family(sd, model.name)
            stats = weights_lib.port_torchvision(model.detector, sd, family)
            self._print(f"ported {stats['merged']} tensors from "
                        f"{torch_weights} ({family}); reinitialised: "
                        f"{stats['dropped_class_dependent'] or 'none'}")
        self.opt_config, self.base_lr = step_lib.make_optimizer(model.name,
                                                                backbone)
        self.opt_state = init_opt_state(dict(model.named_parameters()),
                                        self.opt_config)

        # fused DG pairs: mode 0 then mode k on the same batch in one step,
        # two sequential optimizer updates — the reference's replayed-batch
        # schedule, minus one host decode and copy per pair
        self.fused_pairs = bool(fused_pairs) and dg
        if mesh is not None:
            # each rank loads its row block of every host batch
            train_loader.rows = mesh.row_block(train_loader.batch_size)
        if self.fused_pairs:
            self._pair_i = 0
            # the fused step consumes each batch once
            if getattr(train_loader, "dg", False):
                train_loader.dg = False
        self.scheduler = step_lib.ModeScheduler(dg)
        self.plateau = ReduceLROnPlateau()
        self.early_stop = EarlyStopping()
        self.best_val = -float("inf")
        self.global_step = 0

        # warm start (train_driving_dg.py:154-155)
        self.sharding = {}  # {name: dim} of the parameters split over 'model'
        loaded = self._load_latest()
        if loaded is not None:
            meta = self._load(loaded)
            self.best_val = meta.get("val_acc", -float("inf"))
            self._print(f"warm-started from {self.ckpt_path} "
                        f"(val_acc={self.best_val})")
        if mesh is not None:
            multihost.broadcast_module(self.model)
            self.sharding = shard_model(self.model, mesh)
            self.opt_state = shard_state(self.opt_state, self.sharding, mesh)

        # the steps hold the parameters: built after sharding rebinds some
        hyper = (self.reg_weights, self.opt_config, self.base_lr, mesh)
        if self.fused_pairs:
            self.pair_steps = {k: step_lib.make_pair_step(model, k, *hyper)
                               for k in (1, 2, 3, 4)}
        else:
            modes = (0, 1, 2, 3, 4) if dg else (0,)
            self.steps = {m: step_lib.make_train_step(model, m, *hyper)
                          for m in modes}
        self.eval_step = step_lib.make_eval_step(model)

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg)

    def _load_latest(self):
        """The newest checkpoint, or None. On a mesh rank 0 alone reads it
        and every rank gets rank 0's (the nodes need not share the weights
        folder), so all ranks hold the same `best_val` and optimizer state
        and take the same checkpoint decisions."""
        if self.mesh is None:
            return self.store.load_latest()
        return multihost.broadcast_object(
            self.store.load_latest() if self.is_main else None)

    def _load(self, loaded) -> Dict[str, Any]:
        """A checkpoint's full tensors into the model and the optimizer
        state (this rank's slices of the split ones)."""
        params, opt_state, meta = loaded
        if self.sharding:
            params = shard_state(params, self.sharding, self.mesh)
            opt_state = shard_state(opt_state, self.sharding, self.mesh)
        self.model.load_state_dict(params)
        self.opt_state = tree_to(opt_state, self.device)
        return meta

    def _draws(self, rows: int, num_gt: int, with_rpn: bool):
        return spmd.make_draws(self.model, self.mesh, rows, num_gt, self.gen,
                               with_rpn=with_rpn)

    def train_epoch(self) -> Dict[str, float]:
        """One pass over the train loader. -> the last logged metrics with
        `images_per_sec`, the images trained over the epoch's wall time
        from a synchronised start to a synchronised end, and
        `loader_wait_s`, the host's seconds blocked waiting for the next
        batch of `device_prefetch`."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        n_images = 0
        loader_wait_s = 0.0
        last_metrics = {}
        metrics = None
        batches = device_prefetch(self.train_loader.epoch(), self.device)
        while True:
            t_wait = time.perf_counter()
            with span("dgod.loader_wait"):
                batch = next(batches, None)
            loader_wait_s += time.perf_counter() - t_wait
            if batch is None:
                break
            lr_scale = self.plateau.scale
            if self.warmup_steps and self.global_step < self.warmup_steps:
                lr_scale *= (self.global_step + 1) / self.warmup_steps
            b, g = batch["boxes"].shape[:2]
            # the images of the global batch: every data coordinate's rows
            images = b * (self.mesh.data if self.mesh is not None else 1)
            if self.fused_pairs:
                mode = (1, 2, 3, 4)[self._pair_i]
                self._pair_i = (self._pair_i + 1) % 4
                d0 = self._draws(b, g, with_rpn=True)
                dk = self._draws(b, g, with_rpn=False)
                self.opt_state, metrics = self.pair_steps[mode](
                    self.opt_state, batch, d0, dk, lr_scale)
                # two optimizer steps, each visiting the batch once
                n_images += 2 * images
                self.global_step += 2
            else:
                mode = self.scheduler.next_mode()
                draws = self._draws(b, g, with_rpn=mode == 0)
                self.opt_state, metrics = self.steps[mode](
                    self.opt_state, batch, draws, lr_scale)
                n_images += images
                self.global_step += 1
            if self.global_step % self.log_every < (2 if self.fused_pairs
                                                    else 1):
                last_metrics = {k: float(v) for k, v in metrics.items()}
                self.metrics.log("train", self.global_step,
                                 {"mode": mode, **last_metrics})
                self._print(f"step {self.global_step} mode {mode} loss "
                            f"{last_metrics.get('loss', float('nan')):.4f}")
        if cuda:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if not last_metrics and metrics is not None:
            # no step hit the log cadence this epoch: report the last one
            last_metrics = {k: float(v) for k, v in metrics.items()}
        return {"images_per_sec": n_images / max(dt, 1e-9),
                "loader_wait_s": loader_wait_s, **last_metrics}

    def _fetch(self, dets):
        """Start the copy of a predict's outputs to the host: on the card a
        non-blocking copy into pinned memory and an event; the event is
        waited on only when the host needs the values."""
        with span("dgod.fetch"):
            if self.device.type != "cuda":
                return {k: dets[k] for k in _DET_KEYS}, None
            host = {}
            for k in _DET_KEYS:
                host[k] = torch.empty(dets[k].shape, dtype=dets[k].dtype,
                                      pin_memory=True)
                host[k].copy_(dets[k], non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    def validate(self, loader=None) -> Dict[str, Any]:
        # one-batch pipeline: dispatch the predict of batch k+1 BEFORE the
        # host-side numpy mAP matching of batch k, so the card computes the
        # next batch while the host consumes the previous one. The
        # reference's val loop is fully serial (DGcommon.py:154-166).
        #
        # On a mesh each rank predicts its row block of every batch (the
        # whole batch where the rows do not divide over the node's data
        # coordinates), keeps its images' padded per-image arrays, and
        # they are gathered once at the end (`_update_from_all_ranks`).
        loader = loader or self.val_loader
        metric = MeanAveragePrecision()
        store, start = None, 0
        if self.mesh is not None:
            store = []
            loader.rows = (self.mesh.row_block(loader.batch_size)
                           if loader.batch_size % self.mesh.local_data == 0
                           else None)
            start = (loader.rows or (0,))[0]
        pending = None
        pin = self.device.type == "cuda"
        for k, batch in enumerate(loader):
            placed = {key: to_tensor(v, self.device, pin=pin)
                      for key, v in batch.items()}
            fetched = self._fetch(self.eval_step(placed))
            if pending is not None:
                self._harvest(metric, store, *pending)
            # gt stays on the host; `first`: the batch's first row's index
            pending = (*fetched, batch, k * loader.batch_size + start)
        if pending is not None:
            self._harvest(metric, store, *pending)
        if store is not None:
            self._update_from_all_ranks(metric, store)
        return metric.compute()

    @staticmethod
    def _harvest(metric, store, dets, done, batch, first):
        """A batch's real images into the metric, or, on a mesh, into
        `store` with their index in the loader's order."""
        if done is not None:
            done.synchronize()
        dets = {k: v.numpy() for k, v in dets.items()}
        n_real = batch.get("num_real", dets["boxes"].shape[0])
        if store is not None:
            store.append({"index": np.arange(first, first + n_real),
                          **{k: v[:n_real] for k, v in dets.items()},
                          "gt_boxes": batch["boxes"][:n_real],
                          "gt_labels": batch["labels"][:n_real],
                          "gt_valid": batch["gt_valid"][:n_real]})
            return
        for i in range(n_real):
            metric.update(dets["boxes"][i], dets["scores"][i],
                          dets["labels"][i], batch["boxes"][i],
                          batch["labels"][i], pred_valid=dets["valid"][i],
                          gt_valid=batch["gt_valid"][i])

    @staticmethod
    def _update_from_all_ranks(metric, store):
        """Gather every rank's stored images (padded to the largest count)
        and feed each image once, in dataset order, into the metric: the
        ranks of one data coordinate, and all ranks where a batch was not
        split, hold the same images."""
        if not store:
            raise RuntimeError(
                "validate on a mesh: this rank's loader gave no batch")
        local = {k: np.concatenate([s[k] for s in store]) for k in store[0]}
        n = len(local["index"])
        local["node"] = np.full(n, multihost.node_index())
        counts = np.atleast_1d(multihost.all_gather_host_arrays(
            np.asarray(n, np.int64)))
        n_max = int(counts.max())
        local = {k: np.concatenate([v, np.zeros((n_max - n, *v.shape[1:]),
                                                v.dtype)])
                 for k, v in local.items()}
        got = multihost.all_gather_host_arrays(local)
        if multihost.world_size() == 1:
            got = {k: v[None] for k, v in got.items()}
        first = {}  # (node, index) -> (rank, row)
        for r, count in enumerate(counts):
            for i in range(int(count)):
                first.setdefault((int(got["node"][r, i]),
                                  int(got["index"][r, i])), (r, i))
        for key in sorted(first):
            r, i = first[key]
            metric.update(got["boxes"][r, i], got["scores"][r, i],
                          got["labels"][r, i], got["gt_boxes"][r, i],
                          got["gt_labels"][r, i],
                          pred_valid=got["valid"][r, i],
                          gt_valid=got["gt_valid"][r, i])

    def _save_checkpoint(self, epoch: int, val_acc: float):
        """The full tensors (split ones gathered over the model group), to
        a file rank 0 alone writes; the other ranks wait for it."""
        params, opt_state = self.model.state_dict(), self.opt_state
        if self.sharding:
            params = gather_state(params, self.sharding, self.mesh)
            opt_state = gather_state(opt_state, self.sharding, self.mesh)
        if self.is_main:
            self.store.save(epoch, params, opt_state,
                            {"val_acc": val_acc, "epoch": epoch})
        multihost.barrier()

    def fit(self):
        try:
            for epoch in range(self.max_epochs):
                train_stats = self.train_epoch()
                val = self.validate()
                val_acc = val["map_50"]
                self.metrics.log(
                    "epoch", epoch,
                    {"val_acc": val_acc,
                     "images_per_sec": train_stats["images_per_sec"],
                     "loader_wait_s": train_stats["loader_wait_s"],
                     "lr_scale": self.plateau.scale},
                )
                self._print(f"epoch {epoch}: val mAP@0.5 {val_acc:.4f} "
                            f"({train_stats['images_per_sec']:.2f} img/s) "
                            f"per-class {val['map_per_class']}")
                if val_acc > self.best_val:
                    self.best_val = val_acc
                    self._save_checkpoint(epoch, val_acc)
                self.plateau.step(val_acc)
                if self.early_stop.step(val_acc):
                    self._print(f"early stopping at epoch {epoch}")
                    break
            self.store.wait()
        finally:
            # a ProcessTrainLoader's child and its shared memory must not
            # outlive the fit, even one that failed
            if hasattr(self.train_loader, "close"):
                self.train_loader.close()
        return self.best_val

    def test(self, test_loader) -> Dict[str, Any]:
        """Reload the best checkpoint and sweep the target domain
        (train_driving_dg.py:166-168)."""
        self.store.wait()
        loaded = self._load_latest()
        if loaded is not None:
            self._load(loaded)
        result = self.validate(test_loader)
        self._print(f"test mAP@0.5 {result['map_50']:.4f} "
                    f"per-class {result['map_per_class']}")
        return result
