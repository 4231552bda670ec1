#!/usr/bin/env python3
"""Multi-GPU training of the port (dgod_tpu_torch/parallel/) on 2-4 cards
of one host, the counterpart of scripts/check_multiprocess_cpu.py:

    python3 scripts/check_multigpu_torch.py [--ranks N] [--out FILE]
    python3 scripts/check_multigpu_torch.py --references --ranks N

Each run spawns N ranks, one per card, in an NCCL group
(scripts/rank_launch.py), and drives full-width DG Faster R-CNN (SGD) and
DG FCOS (Adam) through `Trainer(mesh=...)`, one DG cycle of four fused
pairs from a calibrated random init (seed 0) on synthetic batches of 8.

Each mesh cycle is held to a one-card cycle of the same arithmetic
(`blocked_cycle`): every step half evaluates the loss on each row block of
the global batch apart (the forwards the ranks run), adds the blocks'
gradients and divides where the mesh averages, as
`spmd.reduce_active_grads` does. Only the order of the collectives' sums
differs. Faster R-CNN's discrete choices (top-k, NMS, sampled RoIs) turn a
rounding difference into a jump of its losses after an SGD update, so a
cycle on 8-row forwards is no reference for one on 4-row forwards: the
references stage reads how far they part (the batch split), how far the
one-card cycle parts from itself from an init perturbed by one part in a
million, and holds the reference to the Trainer (one block: bit for bit).

1. DP, `data=N` (the JAX package's shard_map semantics): every rank ends
   the cycle with the same parameters bit for bit, and the cycle agrees
   with the reference of N row blocks, each drawing its priorities from
   the same generator state: the first pair's losses within
   FIRST_PAIR_RTOL, every pair's losses (and, under SGD, the cycle's
   update of the parameters) within CYCLE_RTOL. A planted fault (the
   reduction sums and does not divide) must fail these gates;
2. TP, `data=N/2,model=2` (the unsharded step's semantics): the same
   gates against the reference of N/2 row blocks with the split layers
   computed in 2 output slices; the difference from the 8-row one-card
   cycle is printed beside each check;
3. images/s of the DP cycle at 1, 2, ... N ranks with 8 images per rank
   (the second of two cycles, timed from a barrier to a synchronised end
   on every rank; the slowest rank's time counts; default cuDNN settings).

The checks run under deterministic cuDNN and algorithms. The kernels'
launches per rank are reported. It prints one line per check and one JSON
object as its last line (also written to `--out`), and exits non-zero
when a check fails. `--references` runs only the one-card stage (one card
is enough). `--device cpu --small` rehearses it on gloo ranks of the CPU
at a small size (no number of it is a card's).
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig  # noqa: E402
from scripts import rank_launch  # noqa: E402

FAMILIES = ("FRCNN", "FCOS")
GLOBAL_BATCH = 8  # the correctness checks' global batch
PER_RANK = 8  # the scaling runs' images per rank
PERTURB = 1e-6  # the sensitivity reading's relative perturbation
# the gates of a mesh cycle against its reference (relative): the first
# pair's losses (one update apart: the sums' order is all that differs),
# every pair's losses and, under SGD, the cycle's update of the parameters
# (a rounding difference grows over the cycle, see the readings). Adam's
# update is reported, not gated: an Adam step moves every element by about
# lr * sign(g), so a rounding difference flips the noise-level elements;
# on one card a batch split alone moves FCOS's update by 0.78 (relative),
# and a planted fault by 0.45 (PERF.md, section 6)
FIRST_PAIR_RTOL = 1e-4
CYCLE_RTOL = 1e-2
SMALL_FRCNN = dict(rpn_pre_nms_train=256, rpn_pre_nms_test=256,
                   rpn_post_nms_train=256, rpn_post_nms_test=256,
                   rpn_batch_per_image=64, box_batch_per_image=64)


def model_kw(small: bool, family: str) -> dict:
    if not small:
        return dict(canvas=(608, 1216))
    kw = dict(canvas=(64, 128), block_counts=(1, 1, 1, 1),
              compute_dtype=torch.float32)
    if family == "FRCNN":
        kw["config"] = FRCNNConfig(**SMALL_FRCNN)
    return kw


def deterministic(dev) -> None:
    """The checks' settings: no TF32, deterministic cuDNN and algorithms
    (CUBLAS_WORKSPACE_CONFIG is set before CUDA starts, in `main`)."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)


def counts():
    from dgod_tpu_torch.ops import (cuda_matchers, cuda_nms, cuda_proposals,
                                    cuda_roi_align)

    return {"K1": cuda_roi_align.fwd_launches,
            "K2": cuda_roi_align.bwd_launches,
            "K3": cuda_matchers.launches, "K4": cuda_matchers.fcos_launches,
            "K5": cuda_proposals.launches, "K6": cuda_nms.launches}


def cycle_trainer(family, device, mesh, batch, small, root, perturb=0.0):
    """A Trainer over 4 synthetic host batches of `batch` rows (one DG
    cycle), from the calibrated init of seed 0 (each parameter times
    1 + `perturb` * N(0, 1) where given); every pair's metrics are kept in
    `trainer.pair_metrics`."""
    from dgod_tpu_torch.train.harness import Trainer
    from dgod_tpu_torch.utils.synthetic import HostBatches, synthetic_model

    model, host = synthetic_model(family, device, batch=batch, n_batches=4,
                                  **model_kw(small, family))
    if perturb:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=gen)
                       .to(p.device))
    t = Trainer(model, HostBatches(host, dg=True), None, dg=True, seed=0,
                log_every=10 ** 9, device=device, mesh=mesh,
                ckpt_path=os.path.join(root, f"{family}.ckpt"))
    t.pair_metrics = []
    for k, step in t.pair_steps.items():
        def logged(*a, _step=step, **kw):
            opt_state, metrics = _step(*a, **kw)
            t.pair_metrics.append({"loss0": metrics["loss0"],
                                   "loss": metrics["loss"]})
            return opt_state, metrics
        t.pair_steps[k] = logged
    return t, host


def losses(t):
    return [[float(m["loss0"]), float(m["loss"])] for m in t.pair_metrics]


def state_of(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def plain_cycle(family, dev, small, root, perturb=0.0):
    """The Trainer's one-card cycle on the 8-row global batch. -> (each
    pair's [loss0, loss], the parameters after the cycle, before it)."""
    t, _ = cycle_trainer(family, dev, None, GLOBAL_BATCH, small, root,
                         perturb)
    init = state_of(t.model)
    t.train_epoch()
    return losses(t), state_of(t.model), init


def _split_forward(layer, parts, x):
    """`layer` (a Conv or Dense) on one device as tensor parallelism
    computes it over `parts` ranks: each output slice apart, gathered as
    tensor_parallel.gather_from_model gathers them."""
    from dgod_tpu_torch.models.layers import Conv

    conv = isinstance(layer, Conv)
    dim = 1 if conv else -1
    n = layer.weight.shape[0] // parts
    dt = layer.dtype
    # one node for the slices' input gradients, summed before they join
    # those of x's other users, as copy_to_model's all-reduce sums them
    x = x.view_as(x)
    outs = []
    for i in range(parts):
        w = layer.weight[i * n:(i + 1) * n].to(dt)
        b = None if layer.bias is None else \
            layer.bias[i * n:(i + 1) * n].to(dt)
        y = (F.conv2d(x.to(dt), w, b, layer.stride, layer.padding) if conv
             else F.linear(x.to(dt), w, b))
        outs.append(y.movedim(dim, -1).contiguous())
    return torch.cat(outs, -1).movedim(-1, dim)


def split_outputs(model, parts: int) -> list:
    """Compute the layers tensor parallelism splits (mesh.param_sharding's
    rule at a model axis of `parts`) in `parts` output slices, in place.
    -> the split layers' names."""
    from dgod_tpu_torch.parallel.mesh import param_sharding

    names = sorted({n.rsplit(".", 1)[0] for n in param_sharding(
        model, types.SimpleNamespace(model=parts))})
    for name in names:
        layer = model.get_submodule(name)
        layer.forward = functools.partial(_split_forward, layer, parts)
    return names


def blocked_cycle(family, dev, small, blocks: int, glob: bool,
                  split: int = 1):
    """The one-card reference of a mesh cycle with `blocks` data ranks,
    from the Trainer's init, batches and generator: each half evaluates
    the loss on each of the `blocks` row blocks of the global batch apart,
    adds their gradients (a None as zeros) and, where the mesh averages,
    divides the sum by `blocks` (a device tensor, as
    spmd.reduce_active_grads), then applies the update.

    glob=False: DP (shard_map) semantics: every block draws its priorities
    from the same generator state for its own rows, each loss normalised
    over its block, every half averaged. glob=True: the unsharded step's:
    priorities drawn for the global rows, FCOS's foreground count summed
    over the blocks, mode 0 summed and modes 1-4 averaged; `split` > 1
    computes the tensor-parallel layers in that many output slices.
    -> (each pair's [loss0, loss], the parameters after the cycle)."""
    from dgod_tpu_torch.models.dg_frcnn import batch_to_torch
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.train.optim import apply_updates, init_opt_state
    from dgod_tpu_torch.utils.synthetic import REG_WEIGHTS, synthetic_model

    model, host = synthetic_model(family, dev, batch=GLOBAL_BATCH,
                                  n_batches=4, **model_kw(small, family))
    if split > 1:
        split_outputs(model, split)
    opt_config, lr = S.make_optimizer(family)
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params, opt_config)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = GLOBAL_BATCH // blocks
    cut = [slice(i * rows, (i + 1) * rows) for i in range(blocks)]

    def draws(g, with_rpn):
        if not glob:
            return [model.make_draws(rows, g, gen, with_rpn=with_rpn)] * blocks
        d = model.make_draws(GLOBAL_BATCH, g, gen, with_rpn=with_rpn)
        return [None if d is None else type(d)(*(
            None if t is None else t[c].contiguous() for t in d))
            for c in cut]

    out = []
    for mode_k, host_batch in zip((1, 2, 3, 4), host):
        full = batch_to_torch(host_batch, dev)
        parts = [{k: v[c] for k, v in full.items()} for c in cut]
        g = full["boxes"].shape[1]
        d0, dk = draws(g, True), draws(g, False)
        targets = [model.pair_targets(p) for p in parts]
        if glob and "matched" in targets[0]:
            count = sum((t["matched"] >= 0).sum() for t in targets)
            for t in targets:
                t["fg_count"] = count
        pair = []
        for mode, ds in ((0, d0), (mode_k, dk)):
            mset = S.mode_set(model, mode)
            S.stop_inactive_grads(mset)
            names = mset.names
            acc = {n: torch.zeros_like(params[n]) for n in names}
            total = torch.zeros((), device=dev)
            for p, d, tg in zip(parts, ds, targets):
                loss, _ = model.loss_for_mode(p, d, mode, REG_WEIGHTS, **tg)
                grads = torch.autograd.grad(
                    loss, [params[n] for n in names], allow_unused=True)
                for n, gr in zip(names, grads):
                    if gr is not None:
                        acc[n] += gr.float()
                total += loss.detach().float()
            if not (glob and mode == 0):
                div = torch.full((), float(blocks), device=dev)
                acc = {n: v / div for n, v in acc.items()}
                total = total / div
            opt_state = apply_updates(params, acc, opt_state, mset.active,
                                      lr, opt_config)
            pair.append(float(total))
        out.append(pair)
    return out, state_of(model)


def compare(got, want, init) -> dict:
    """Two cycles from `init` ([loss0, loss] per pair, parameters after):
    the relative loss differences (the first pair's, every pair's), the
    relative L2 difference of the cycle's updates (|dgot - dwant| /
    |dwant| over all parameters, so Adam's sign flips of noise-level
    gradients weigh what they move) and the largest absolute parameter
    difference."""
    (gl, gp), (wl, wp) = got[:2], want[:2]
    rel = np.abs(np.subtract(gl, wl)) / np.maximum(np.abs(wl), 1e-12)
    dev = next(iter(wp.values())).device
    num = den = 0.0
    dmax = 0.0
    for k, w in wp.items():
        g, w0 = gp[k].to(dev).double(), init[k].to(dev).double()
        num += float(((g - w.double()) ** 2).sum())
        den += float(((w.double() - w0) ** 2).sum())
        dmax = max(dmax, float((g - w.double()).abs().max()))
    return {"first_pair_rel_diff": float(rel[0].max()),
            "max_rel_loss_diff": float(rel.max()),
            "update_rel_diff": (num / den) ** 0.5 if den else num ** 0.5,
            "max_abs_param_diff": dmax}


def within_gates(diff: dict, family: str) -> bool:
    from dgod_tpu_torch.train.steps import make_optimizer

    sgd = make_optimizer(family)[0].kind == "sgd"
    return (diff["first_pair_rel_diff"] <= FIRST_PAIR_RTOL
            and diff["max_rel_loss_diff"] <= CYCLE_RTOL
            and (not sgd or diff["update_rel_diff"] <= CYCLE_RTOL))


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for _, p in sorted(state.items()):
        h.update(p.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def timed_cycle_s(t, device) -> float:
    """Seconds of one DG cycle on this rank, from a barrier."""
    import torch.distributed as dist

    from dgod_tpu_torch.utils.timing import synchronize

    synchronize(device)
    dist.barrier()
    start = time.perf_counter()
    t.train_epoch()
    synchronize(device)
    return time.perf_counter() - start


def rank_main(spec, batch, small, timed, root, device, plant=False):
    """One rank: each family's cycle under `spec` (deterministic settings
    unless `timed`; with `plant` the data-group reduction sums without
    dividing, a fault the DP gate must catch); -> its numbers."""
    from dgod_tpu_torch.device import resolve_device
    from dgod_tpu_torch.parallel import mesh as mesh_lib
    from dgod_tpu_torch.parallel import multihost, spmd
    from dgod_tpu_torch.parallel.tensor_parallel import gather_state

    dev = resolve_device(device)
    if timed:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        deterministic(dev)
    if plant:
        reduce = spmd.reduce_active_grads
        spmd.reduce_active_grads = lambda *a, **k: reduce(
            *a, **{**k, "average": False})
    out = {}
    for family in FAMILIES:
        c0 = counts()
        mesh = mesh_lib.parse_mesh_spec(spec)
        t, _ = cycle_trainer(family, dev, mesh, batch, small, root)
        t.train_epoch()
        full = gather_state(t.model.state_dict(), t.sharding, mesh)
        r = {"losses": losses(t), "digest": digest(full),
             "launches": {k: v - c0[k] for k, v in counts().items()}}
        if multihost.rank() == 0:
            path = os.path.join(root, f"params_{family}.pt")
            torch.save({k: v.cpu() for k, v in full.items()}, path)
            r["params"] = path
        if timed:
            r["cycle_s"] = timed_cycle_s(t, dev)
            r["images"] = 2 * batch * 4
        out[family] = r
        del t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: every card)")
    ap.add_argument("--device", default=None,
                    help="'cpu' rehearses on gloo ranks")
    ap.add_argument("--small", action="store_true",
                    help="64x128 canvas, blocks (1,1,1,1), f32")
    ap.add_argument("--references", action="store_true",
                    help="only the one-card references and their readings")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each launch of ranks may take")
    args = ap.parse_args(argv)
    # deterministic cuBLAS needs it before CUDA starts (ranks inherit it)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with tempfile.TemporaryDirectory() as work:
        return run_checks(args, work)


def references(family, dev, world, small, work, check) -> dict:
    """The one-card cycles of `family` that the mesh cycles are held to,
    and the readings that tell how far rounding alone moves a cycle."""
    plain = plain_cycle(family, dev, small, work)
    init = plain[2]
    one = blocked_cycle(family, dev, small, 1, glob=False)
    same = bool(np.array_equal(one[0], plain[0])
                and all(torch.equal(one[1][k], v)
                        for k, v in plain[1].items()))
    check(f"reference {family}: one block is the Trainer's cycle", same,
          {"bit_identical": same})
    dp = blocked_cycle(family, dev, small, world, glob=False)
    tp = blocked_cycle(family, dev, small, world // 2, glob=True, split=2)
    unsplit = blocked_cycle(family, dev, small, world // 2, glob=True)
    perturbed = plain_cycle(family, dev, small, work, PERTURB)
    readings = {"batch_split": compare(unsplit, plain, init),
                "layer_split": compare(tp, unsplit, init),
                f"perturbed_{PERTURB:g}": compare(perturbed, plain, init),
                "plain_losses": plain[0], "unsplit_losses": unsplit[0]}
    print(f"readings {family}: {json.dumps(readings)}", flush=True)
    return {"plain": plain, "dp": dp, "tp": tp, "init": init,
            "readings": readings}


def run_checks(args, work: str) -> int:
    """The checks, with every file they write under `work`."""
    from dgod_tpu_torch.device import resolve_device
    from dgod_tpu_torch.utils.timing import card

    dev = resolve_device(args.device)
    world = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                           else 2)
    if world < 2 or world % 2 or GLOBAL_BATCH % world:
        print(f"check_multigpu: needs an even number of ranks from 2 to "
              f"{GLOBAL_BATCH}, have {world}", file=sys.stderr)
        return 1
    if dev.type == "cuda":
        from dgod_tpu_torch.ops import _build

        _build.build()  # once, before the ranks load it
    else:
        torch.set_num_threads(1)  # the ranks' arithmetic
    deterministic(dev)
    smi = card(dev)
    nccl = (".".join(map(str, torch.cuda.nccl.version()))
            if dev.type == "cuda" else None)
    print(f"check_multigpu: {world} ranks on {smi}, torch "
          f"{torch.__version__}, nccl {nccl}; gates (relative): first "
          f"pair {FIRST_PAIR_RTOL:g}, cycle {CYCLE_RTOL:g}", flush=True)
    result = {"device": smi, "ranks": world, "nccl": nccl,
              "small": args.small, "checks": {}}
    failed = []

    def check(name, ok, detail):
        result["checks"][name] = {"ok": bool(ok), **detail}
        print(f"{'PASS' if ok else 'FAIL'} {name}: {json.dumps(detail)}",
              flush=True)
        if not ok:
            failed.append(name)

    ref = {f: references(f, dev, world, args.small, work, check)
           for f in FAMILIES}
    result["readings"] = {f: r["readings"] for f, r in ref.items()}
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # rank 0 shares this card
    if not args.references:
        run_mesh_checks(args, work, world, ref, check, result)
    result["ok"] = not failed
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if failed else 0


def run_mesh_checks(args, work, world, ref, check, result) -> None:
    def run(spec, n, batch, timed, plant=False):
        root = tempfile.mkdtemp(prefix=f"ranks{n}_", dir=work)
        got = rank_launch.spawn(
            rank_main, n, (spec, batch, args.small, timed, root, args.device,
                           plant),
            store_dir=root, device=args.device, timeout=args.timeout)
        for family in FAMILIES:
            path = got[0][family].pop("params", None)
            if path:
                got[0][family]["state"] = torch.load(path, weights_only=True)
        return got

    tp_spec = f"data={world // 2},model=2"
    for name, spec, want, plant in (
            (f"DP data={world}", f"data={world}", "dp", False),
            (f"TP {tp_spec}", tp_spec, "tp", False),
            (f"planted fault (DP sums without dividing) data={world}",
             f"data={world}", "dp", True)):
        ranks = run(spec, world, GLOBAL_BATCH, False, plant)
        for family in FAMILIES:
            r0 = ranks[0][family]
            got = (r0["losses"], r0["state"])
            init = ref[family]["init"]
            diff = compare(got, ref[family][want], init)
            same = len({r[family]["digest"] for r in ranks}) == 1
            finite = bool(np.isfinite(r0["losses"]).all())
            held = finite and same and within_gates(diff, family)
            # the planted fault passes when the gates catch it
            check(f"{name} {family}", held != plant,
                  {"within_gates": held, "replicas_bit_identical": same,
                   **diff,
                   "vs_8_row_one_card_cycle": compare(
                       got, ref[family]["plain"], init),
                   "losses": r0["losses"],
                   "reference_losses": ref[family][want][0],
                   "launches_rank0": r0["launches"]})

    # scaling: DP at 8 images per rank, 1, 2, ... world ranks
    scaling = {f: {} for f in FAMILIES}
    n = 1
    while n <= world:
        got = run(f"data={n}", n, PER_RANK * n, True)
        for family in FAMILIES:
            cycle_s = max(r[family]["cycle_s"] for r in got)
            scaling[family][n] = {
                "images_per_s": got[0][family]["images"] / cycle_s,
                "cycle_s": cycle_s}
        n *= 2
    result["scaling"] = scaling
    print(f"DP images/s at {PER_RANK} per rank ({result['device']}): "
          + json.dumps({f: {n: v["images_per_s"] for n, v in s.items()}
                        for f, s in scaling.items()}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
