"""Synthetic inputs for runs from random weights (chip_smoke.py,
bench_torch.py, the split scripts): training batches of uint8 images with
2-8 boxes each, FrozenBatchNorm statistics taken from a batch, and the DG
training cycle built on them (`build_dg_cycle`, `run_dg_cycle`), the one
that chip_smoke.py's main path and the bench both time."""

from __future__ import annotations

import numpy as np
import torch

from ..models.resnet import FrozenBatchNorm


def synthetic_batch(rng: np.random.RandomState, b: int, canvas,
                    num_domains: int, max_gt: int = 128):
    """A training batch as the loaders give it (numpy): random uint8
    images of `canvas`, 2-8 boxes per image inside the canvas, labels
    1..8, domains in turn."""
    H, W = canvas
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        n = rng.randint(2, 9)
        xy = rng.uniform([0, 0], [W * 0.8, H * 0.8], (n, 2))
        wh = rng.uniform(0.05, 0.3, (n, 2)) * [W, H]
        boxes[i, :n] = np.concatenate([xy, np.minimum(xy + wh, [W, H])], 1)
        labels[i, :n] = rng.randint(1, 9, n)
        valid[i, :n] = True
    return {
        "image": rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
        "boxes": boxes,
        "labels": labels,
        "gt_valid": valid,
        "domain": (np.arange(b) % num_domains).astype(np.int32),
        "image_size": np.tile(np.float32(canvas), (b, 1)),
        "scale_back": np.ones((b, 2), np.float32),
    }


def calibrate_frozen_bn(model, images: torch.Tensor) -> None:
    """Set every FrozenBatchNorm's mean/var to the per-channel statistics
    of its own input on `images` (uint8 NHWC on the model's device), in
    network order. Random convolutions under identity batch-norm let
    ResNet-50's activations grow block by block until the first SGD steps
    diverge; a pretrained checkpoint's statistics keep them in range, and
    these stand in for them."""

    def pre_hook(mod, inputs):
        x = inputs[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(pre_hook) for m in model.modules()
               if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            model.detector.features(model.normalize(images))
    finally:
        for h in handles:
            h.remove()


PAIRS = (1, 2, 3, 4)
REG_WEIGHTS = (0.5, 0.5, 0.5, 0.05, 1e-4)


def synthetic_model(family: str, device, *, canvas=(608, 1216), batch=8,
                    num_domains=3, block_counts=(3, 4, 6, 3),
                    compute_dtype=torch.bfloat16, config=None, n_batches=1,
                    seed=0, data_seed=5):
    """The family's model from random weights (drawn from `seed`) and
    `n_batches` synthetic host batches (numpy, from
    `RandomState(data_seed)`), FrozenBatchNorm calibrated from the first.
    `config` is an FRCNNConfig (FRCNN only). -> (model, batches)."""
    from ..models.dg_fcos import DGFCOSModel
    from ..models.dg_frcnn import DGFRCNNModel

    kw = {"config": config} if config is not None else {}
    cls = {"FRCNN": DGFRCNNModel, "FCOS": DGFCOSModel}[family]
    model = cls(num_classes=9, num_domains=num_domains, canvas=canvas,
                compute_dtype=compute_dtype,
                backbone_block_counts=block_counts, device=device, seed=seed,
                **kw)
    rng = np.random.RandomState(data_seed)
    batches = [synthetic_batch(rng, batch, canvas, num_domains)
               for _ in range(n_batches)]
    calibrate_frozen_bn(model, torch.from_numpy(batches[0]["image"]).to(
        model.device))
    return model, batches


class HostBatches:
    """Host batches as a loader of the harness: `epoch()` yields each once
    (a train loader), and so does iterating (an eval loader); `rows`, set
    by a mesh Trainer, keeps a row block of each, as the port's loaders
    do."""

    def __init__(self, batches, dg: bool = False):
        self.batches, self.dg, self.rows = batches, dg, None
        self.batch_size = len(batches[0]["image"])

    def epoch(self):
        lo, hi = self.rows or (0, self.batch_size)
        for b in self.batches:
            yield {k: v[lo:hi] for k, v in b.items()}

    def __iter__(self):
        return self.epoch()


def build_dg_cycle(family: str, device, *, batch=8, n_batches=1, **kw):
    """A DG training cycle from random weights, as the harness runs it:
    `synthetic_model`'s model and batches (on `device`; pairs take them in
    turn), the optimizer state, the fused pair steps (0,k) in the DG
    schedule's order and the eval step. Run it with `run_dg_cycle`; a
    cycle holds `images` images, each pair counting its batch twice as
    `Trainer.train_epoch` does."""
    import types

    from ..models.dg_frcnn import batch_to_torch
    from ..train import steps as S
    from ..train.optim import init_opt_state

    model, host = synthetic_model(family, device, batch=batch,
                                  n_batches=n_batches, **kw)
    batches = [batch_to_torch(b, device) for b in host]
    scheduler = S.ModeScheduler(dg=True)
    pairs = []
    for _ in PAIRS:
        m0, mk = scheduler.next_mode(), scheduler.next_mode()
        if m0 != 0:
            raise RuntimeError("the DG schedule must alternate mode 0 with "
                               "mode k")
        pairs.append(mk)
    opt_config, lr = S.make_optimizer(family)
    return types.SimpleNamespace(
        model=model, batches=batches, batch_size=batch,
        opt_config=opt_config, lr=lr, images=2 * batch * len(pairs),
        opt_state=init_opt_state(dict(model.named_parameters()), opt_config),
        gen=torch.Generator(device=device).manual_seed(0),
        steps={k: S.make_pair_step(model, k, REG_WEIGHTS, opt_config, lr)
               for k in pairs},
        eval_step=S.make_eval_step(model))


def run_dg_cycle(cycle, before_pair=None, after_pair=None,
                 sync_pairs=False):
    """One DG cycle of `build_dg_cycle`: each fused pair (0,k) with its
    sampling draws made just before it. `before_pair(k)` runs before pair
    (0,k) and its result is passed on as `after_pair(k, metrics, state,
    ms)` after it. With `sync_pairs` each pair is timed on the host clock
    from a synchronised start to a synchronised end (`ms`, else None).
    -> {k: the pair's metrics}."""
    from .timing import host_ms

    dev = cycle.batches[0]["image"].device
    g = cycle.batches[0]["boxes"].shape[1]
    out = {}
    for i, (k, step) in enumerate(cycle.steps.items()):
        batch = cycle.batches[i % len(cycle.batches)]
        state = before_pair(k) if before_pair else None
        d0 = cycle.model.make_draws(cycle.batch_size, g, cycle.gen,
                                    with_rpn=True)
        dk = cycle.model.make_draws(cycle.batch_size, g, cycle.gen,
                                    with_rpn=False)

        def pair():
            return step(cycle.opt_state, batch, d0, dk)

        if sync_pairs:
            (cycle.opt_state, metrics), ms = host_ms(pair, dev)
        else:
            (cycle.opt_state, metrics), ms = pair(), None
        out[k] = metrics
        if after_pair:
            after_pair(k, metrics, state, ms)
    return out
