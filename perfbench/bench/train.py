"""The training driver: a cell whose traffic has "kind": "train".

Set-up builds one training object (the program's model, its optimizer
state and its fused pair steps) from the seed and drives it through the DG
cycle's first pairs, through the same call and feed as the window, on
batches whose rows all differ; the readings of those pairs are kept for the
check. The window then runs whole DG cycles of fused pairs (0,1) (0,2)
(0,3) (0,4), each pair with its sampling draws made just before it, until
`seconds` have passed, and ends in a synchronise: the rate is the images
trained over the window's wall time, each pair counting its batch twice as
Trainer.train_epoch counts it.

The check: after the window, with the program's state freed, the plain
reference, computing in the precision the configuration states, starts
from the same weights and follows the first three pairs on the same
batches and draws. Compared are each half's loss, the first pair's
update as the optimizer took it (build.first_update; SGD: the
parameters' change over the learning rate; Adam: the first moment over
1 - b1), per leaf, and the parameters' change after three pairs, per leaf
(compare.py).

What belongs to the architecture (its models and draws) comes from the
configuration's builder (common.builder); the optimizer takes the
configuration's whole `optimizer` object (build.opt_config)."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import build, common, compare, models, synthetic
from .common import Spans
from .timing import synchronize

PATH = "train"


def np_seed(seed: int) -> int:
    """numpy's RandomState takes 32 bits; the benchmark's seeds may need
    more."""
    return int(seed) % 2**32


def host_batches(traffic: dict, config: dict, seed: int) -> list:
    """`traffic["batches"]` distinct host batches from the traffic's
    generator, drawn from the seed."""
    rng = np.random.RandomState(np_seed(seed))
    gen = synthetic.GENERATORS[traffic["generator"]]
    return [gen(rng, traffic["batch"], tuple(config["canvas"]),
                config["num_domains"], max_gt=traffic["max_gt"])
            for _ in range(traffic["batches"])]


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device).contiguous()
            for k, v in batch.items()}


def draw_maker(config: dict, batch: int, max_gt: int, device, seed: int):
    """-> draws(with_rpn): the sampling priorities of one loss evaluation,
    drawn on the device from the benchmark's generator, as the builder
    makes them (None where the model samples nothing)."""
    return common.builder(config).draw_maker(config, batch, max_gt, device,
                                             seed)


class TrainSide:
    """A model with its optimizer state and fused pair steps, from the
    program's package or the reference's (`steps`, `optim`; `side`
    "program" or "reference"), its optimizer configured from the
    configuration's `optimizer` object and its draws wrapped by the
    configuration's builder."""

    def __init__(self, model, steps, optim, config: dict, side: str):
        self.model = model
        self.lr = float(config["optimizer"]["lr"])
        self.opt_config = build.opt_config(optim, config)
        self.opt_state = optim.init_opt_state(
            dict(model.named_parameters()), self.opt_config)
        reg = tuple(config["reg_weights"])
        self.steps = {k: steps.make_pair_step(model, k, reg,
                                              self.opt_config, self.lr)
                      for k in (1, 2, 3, 4)}
        self.wrap = common.builder(config).wrap_draws(side)

    def pair(self, k: int, batch: dict, d0, dk) -> dict:
        self.opt_state, metrics = self.steps[k](self.opt_state, batch,
                                                self.wrap(d0), self.wrap(dk))
        return metrics

    def _norms(self, tensors: dict) -> dict:
        names = sorted(tensors)
        values = torch.stack([tensors[n].float().norm() for n in names])
        return dict(zip(names, values.tolist()))

    def first_update(self, init: dict) -> dict:
        """Per leaf, the first update as the optimizer took it."""
        return build.first_update(self, init)

    def change(self, init: dict) -> dict:
        params = dict(self.model.named_parameters())
        return {n: p.detach() - init[n] for n, p in params.items()}


def program_side(config: dict, device, state: dict) -> TrainSide:
    from dgod_tpu_torch.train import optim, steps

    model = models.program_model(config, device)
    models.load_state(model, state)
    return TrainSide(model, steps, optim, config, "program")


def reference_side(config: dict, device, state: dict, fp8: bool = False,
                   dtype=None) -> TrainSide:
    from ..reference.train import optim, steps

    model = models.reference_model(config, device, fp8=fp8, dtype=dtype)
    models.load_state(model, state)
    model.grad_log = []
    return TrainSide(model, steps, optim, config, "reference")


def first_pairs(side: TrainSide, plan, init: dict) -> dict:
    """Run the pairs of `plan` ((k, batch, draws0, drawsk) each) on `side`
    and take the check's readings: both halves' losses of the first three,
    the first update and the change after three, per leaf (taken before
    the fourth pair moves the parameters)."""
    losses, out = [], {}
    for j, (k, batch, d0, dk) in enumerate(plan):
        metrics = side.pair(k, batch, d0, dk)
        if j < 3:
            losses += [metrics["loss0"], metrics["loss"]]
        if j == 0:
            out["g1"] = side._norms(side.first_update(init))
        if j == 2:
            out["d3"] = side._norms(side.change(init))
    out["losses"] = [float(x) for x in losses]
    return out


def reference_readings(config: dict, device, state: dict, plan,
                       fp8: bool = False, rows=None, dtype=None) -> dict:
    """The reference's readings of the first three pairs of `plan`, in the
    precision the configuration states (or on fp8 operands, the control;
    or in `dtype`, a witness), float32 without TF32; `rows`: keep only that
    many rows of each batch and draw (a planted fault)."""
    if rows is not None:
        plan = [(k, {n: v[:rows] for n, v in b.items()},
                 *[None if d is None else tuple(
                     None if x is None else x[:rows] for x in d)
                   for d in (d0, dk)])
                for k, b, d0, dk in plan]
    side = reference_side(config, device, state, fp8=fp8, dtype=dtype)
    with models.exact_float32():
        out = first_pairs(side, plan[:3], state)
    out["grad_max"] = {}
    for half in side.model.grad_log:
        for n, v in half.items():
            out["grad_max"][n] = max(v, out["grad_max"].get(n, 0.0))
    return out


def setup(cell: dict, seed: int, device, spans):
    """Everything before the window, the program's first DG cycle and its
    readings included. -> a namespace the window and the check take."""
    import types

    config, traffic = cell["config"], cell["traffic"]
    B, G = traffic["batch"], traffic["max_gt"]
    with spans.span("setup.inputs"):
        batches = [to_device(b, device)
                   for b in host_batches(traffic, config, seed)]
        draws = draw_maker(config, B, G, device, seed)
    with spans.span("setup.weights"):
        state = models.make_state(config, seed, device, batches[0]["image"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    with spans.span("setup.program"):
        side = program_side(config, device, state)
    pairs = traffic["pairs"]
    plan = [(k, batches[i % len(batches)], draws(True), draws(False))
            for i, k in enumerate(pairs)]
    with spans.span("setup.first_cycle"):
        readings = first_pairs(side, plan, state)
    with spans.span("setup.warm"):
        for _ in range(traffic["warm_cycles"]):
            run_cycle(side, batches, draws, pairs, Spans(False), None)
        synchronize(device)
    return types.SimpleNamespace(
        config=config, traffic=traffic, device=device, side=side,
        state=state, batches=batches, draws=draws, pairs=pairs,
        plan=plan[:3], readings=readings, batch=B, max_gt=G)


def run_cycle(side, batches, draws, pairs, spans, bad):
    for i, k in enumerate(pairs):
        with spans.span("draws"):
            d0, dk = draws(True), draws(False)
        with spans.span("pair"):
            metrics = side.pair(k, batches[i % len(batches)], d0, dk)
        if bad is not None:
            bad += (~torch.isfinite(metrics["loss0"])
                    | ~torch.isfinite(metrics["loss"])).int()


def window(s, seconds: float, spans) -> dict:
    """Whole DG cycles until `seconds` have passed; ends in a synchronise."""
    bad = torch.zeros((), dtype=torch.int32, device=s.device)
    cycles = 0
    synchronize(s.device)
    t0 = time.perf_counter()
    while True:
        run_cycle(s.side, s.batches, s.draws, s.pairs, spans, bad)
        cycles += 1
        if time.perf_counter() - t0 >= seconds:
            break
    synchronize(s.device)
    elapsed = time.perf_counter() - t0
    n_pairs = cycles * len(s.pairs)
    return {"seconds": elapsed, "cycles": cycles, "attempted": n_pairs,
            "failed": int(bad), "images": n_pairs * 2 * s.batch}


def profiled_units(s, units: int, spans) -> None:
    for _ in range(units):
        run_cycle(s.side, s.batches, s.draws, s.pairs, spans, None)


def release(s) -> None:
    """Free the program's model, state and steps before the reference
    runs."""
    s.side = None


def check(s) -> dict:
    ref = reference_readings(s.config, s.device, s.state, s.plan)
    return compare.train_numbers(s.readings, ref)


def end_to_end(w: dict) -> dict:
    return {"train_images_per_s": w["images"] / w["seconds"]}
