"""Do the port and the JAX package learn alike, init for init? A seed sweep
of both packages on the CPU, with the recipe of
scripts/check_convergence.py (FrozenBatchNorm at its identity init).

    JAX_PLATFORMS=cpu python3 scripts/compare_learning_jax_torch.py \
        --size deep --run jax:0 --run torch:0 --out sweep.jsonl

Each `--run KIND:SEED` trains `--family` (FCOS, the default, or FRCNN with
the scripts' 600-step LR warm-up) non_dg on the generated shapes
(scripts/check_convergence.py's data) until train mAP@0.5 reaches the
target or the epoch cap:

- `jax:S`            the JAX package, `Trainer(seed=S)` (its init key the
                     second half of `PRNGKey(S)` split, as the JAX
                     convergence script's seed 42);
- `torch:S`          the port, model seed S;
- `jax_from_torch:S` the JAX package started from the port's seed-S init;
- `torch_from_jax:S` the port started from the JAX package's seed-S init.

The last two carry one init across, tensor for tensor, so a run that
stalls in one package can be told apart: from the same init, does the
other package stall too? Sizes: `smoke` is the tier-1 learning test's
(120x240 in a 128x256 canvas, 8 per domain, batch 4, ResNet-50 blocks
(1,1,1,1), target 0.6, 60 epochs); `deep` the same at full depth
(3,4,6,3), target 0.9, 100 epochs; `mid` half the full proof's side
(300x600 in 320x608, 16 per domain, batch 8, full depth), target 0.6, 100
epochs. `--max_epochs` overrides the cap. Appends one JSON line per run
(its curve: epoch, train mAP@0.5, loss) to `--out`.

A comparison of the two packages, so it imports both, as the tests do; it
is not part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from scripts import check_convergence as jax_cc  # noqa: E402
from scripts import check_convergence_torch as cc  # noqa: E402

KINDS = ("jax", "torch", "jax_from_torch", "torch_from_jax")
MODEL_KW = dict(num_classes=9, num_domains=2)


def size_settings(size: str, max_epochs=None) -> dict:
    kw = dict(cc.SMOKE)
    if size == "deep":
        kw.update(block_counts=(3, 4, 6, 3), target=0.9, max_epochs=100)
    elif size == "mid":
        kw = dict(cc.MID)
    if max_epochs is not None:
        kw["max_epochs"] = max_epochs
    return kw


def jax_model_class(family: str):
    if family == "FCOS":
        from dgod_tpu.models.dg_fcos import DGFCOSModel

        return DGFCOSModel
    from dgod_tpu.models.dg_frcnn import DGFRCNNModel

    return DGFRCNNModel


def jax_init(family: str, seed: int, kw: dict):
    """The JAX model's init tree as `Trainer(seed=seed)` draws it."""
    import jax

    model = jax_model_class(family)(
        canvas=kw["canvas"], backbone_block_counts=kw["block_counts"],
        **MODEL_KW)
    _, init_key = jax.random.split(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, model.init(init_key))


def jax_tree_from_torch(template, state_dict):
    """The inverse of `utils.weights.params_from_jax`: the port's
    `state_dict` laid out as the JAX tree `template`."""
    from dgod_tpu_torch.utils.weights import params_from_jax

    keys = list(params_from_jax(template))
    flat = iter(keys)

    def fill(node, path=()):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v, path + (k,))
                continue
            arr = state_dict[next(flat)].detach().cpu().numpy()
            if k == "kernel" and arr.ndim == 4:  # OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif k == "kernel" and arr.ndim == 2:  # [out, in] -> [in, out]
                arr = arr.T
            assert arr.shape == np.shape(v), (path, k, arr.shape)
            out[k] = np.ascontiguousarray(arr, dtype=np.asarray(v).dtype)
        return out

    tree = fill(template)
    # the round trip is exact, so the init carried across is the one drawn
    back = params_from_jax(tree)
    for k, v in state_dict.items():
        assert torch.equal(back[k], v.detach().cpu().float()), k
    return tree


def run_jax(family: str, seed: int, kw: dict, tmpdir: str,
            init_tree=None) -> dict:
    """scripts/check_convergence.py's `run_one`, with the Trainer's seed
    and, optionally, the init tree given."""
    from dgod_tpu.data import transforms as T

    T.CANVAS = kw["canvas"]
    T.TRAIN_SIZE = kw["image_hw"]
    T.MIN_SIZE = min(kw["image_hw"])
    T.MAX_SIZE = max(kw["image_hw"])
    T.MIN_AREA = 4.0

    from dgod_tpu.data.dataset import ConcatDataset
    from dgod_tpu.data.loader import EvalLoader, TrainLoader
    from dgod_tpu.train.harness import Trainer

    class FromTree(jax_model_class(family)):
        def init(self, rng):
            return init_tree if init_tree is not None else super().init(rng)

    hw, n = kw["image_hw"], kw["n_per_domain"]
    train_ds = ConcatDataset([jax_cc.ShapesDataset(n, d, hw, seed=1)
                              for d in (0, 1)])
    model = FromTree(canvas=kw["canvas"],
                     backbone_block_counts=kw["block_counts"], **MODEL_KW)
    trainer = Trainer(
        model, TrainLoader(train_ds, kw["batch_size"], False, num_workers=4),
        EvalLoader(train_ds, min(8, kw["batch_size"]), family == "FCOS",
                   num_workers=4),
        dg=False, max_epochs=0, ckpt_path=os.path.join(tmpdir, "jax.ckpt"),
        log_every=10 ** 9, warmup_steps=warmup(family), seed=seed)
    return _train(trainer, kw)


def warmup(family: str) -> int:
    return cc.FRCNN_WARMUP if family == "FRCNN" else 0


def run_torch(family: str, seed: int, kw: dict, tmpdir: str,
              init_state=None) -> dict:
    return cc.run_one(family, False, warmup_steps=warmup(family),
                      tmpdir=tmpdir,
                      device="cpu", calibrate_bn=False, seed=seed,
                      init_state=init_state, **kw)


def _train(trainer, kw) -> dict:
    curve, best = [], -1.0
    for epoch in range(kw["max_epochs"]):
        stats = trainer.train_epoch()
        m = float(trainer.validate()["map_50"])
        curve.append({"epoch": epoch, "map_50": round(m, 4),
                      "loss": round(stats.get("loss", float("nan")), 4)})
        best = max(best, m)
        if best >= kw["target"]:
            break
    return {"best_map_50": round(best, 4), "reached": best >= kw["target"],
            "epochs": len(curve), "curve": curve}


def run(family: str, kind: str, seed: int, kw: dict) -> dict:
    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmpdir:
        if kind == "jax":
            r = run_jax(family, seed, kw, tmpdir)
        elif kind == "torch":
            r = run_torch(family, seed, kw, tmpdir)
        elif kind == "jax_from_torch":
            cls = DGFCOSModel if family == "FCOS" else DGFRCNNModel
            sd = cls(canvas=kw["canvas"], device="cpu", seed=seed,
                     backbone_block_counts=kw["block_counts"],
                     **MODEL_KW).state_dict()
            r = run_jax(family, seed, kw, tmpdir, init_tree=jax_tree_from_torch(
                jax_init(family, seed, kw), sd))
        else:
            from dgod_tpu_torch.utils.weights import params_from_jax

            r = run_torch(family, seed, kw, tmpdir, init_state=params_from_jax(
                jax_init(family, seed, kw)))
    curve = [(e["epoch"], e["map_50"], e["loss"]) for e in r["curve"]]
    return {"run": kind, "family": family, "seed": seed,
            "best_map_50": r["best_map_50"],
            "reached": r["reached"], "epochs": r["epochs"],
            "wall_s": round(time.time() - t0, 1), "curve": curve}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", action="append", required=True,
                   metavar="KIND:SEED", help=f"KIND in {KINDS}")
    p.add_argument("--family", choices=("FCOS", "FRCNN"), default="FCOS")
    p.add_argument("--size", choices=("smoke", "deep", "mid"),
                   default="smoke")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--threads", type=int, default=2,
                   help="torch intra-op threads")
    p.add_argument("--out", required=True, help="JSON lines, appended")
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    kw = size_settings(args.size, args.max_epochs)
    settings = {k: list(v) if isinstance(v, tuple) else v
                for k, v in kw.items()}
    for spec in args.run:
        kind, seed = spec.split(":")
        if kind not in KINDS:
            p.error(f"unknown run kind {kind!r}")
        r = run(args.family, kind, int(seed), kw)
        r.update(size=args.size, settings=settings, frozen_bn="identity")
        print(json.dumps({k: v for k, v in r.items() if k != "curve"}),
              flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
