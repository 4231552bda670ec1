"""Does the port train alike on the card and on the CPU? FCOS non_dg at the
learning test's size (scripts/check_convergence_torch.py SMOKE: 120x240 in
128x256, 8 images per domain, batch 4, ResNet-50 blocks (1,1,1,1)), the
same init (model seed 0) and the same batches on both devices, in lock
step.

    python3 scripts/compare_card_cpu_training.py [--steps 40] [--dtype f32]

1. the first step's gradients: for every parameter, the largest
   difference between the card's and the CPU's gradient over the largest
   CPU gradient (float32 compute, TF32 off), the worst printed;
2. `--steps` optimizer steps on each device, the same batch for both at
   each step: the two losses side by side;
3. train mAP@0.5 of each device's trained weights, each evaluated on both
   devices (so a gap in training and a gap in the predict are told apart).

Prints one JSON line at the end. Needs a card; the CPU side runs on the
same machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts import check_convergence_torch as cc  # noqa: E402

REG_WEIGHTS = (0.5, 0.5, 0.5, 0.05, 1e-4)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def grads(model, batch):
    from dgod_tpu_torch.data.loader import to_tensor

    model.zero_grad(set_to_none=True)
    placed = {k: to_tensor(v, model.device) for k, v in batch.items()}
    loss, _ = model.loss_for_mode(placed, None, 0, REG_WEIGHTS)
    loss.backward()
    out = {n: p.grad.detach().float().cpu().clone()
           for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="f32")
    p.add_argument("--device", default="cuda",
                   help="the device held against the CPU (cpu: a self-check"
                        " that must show no difference)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("compare_card_cpu_training: no CUDA device", file=sys.stderr)
        return 1
    from dgod_tpu_torch.data.loader import to_tensor
    from dgod_tpu_torch.utils import timing

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    devs = {"cpu": torch.device("cpu"), "card": torch.device(args.device)}
    kw = {k: v for k, v in cc.SMOKE.items()
          if k not in ("max_epochs", "target")}
    result = {"card": timing.card(devs["card"]), "dtype": args.dtype,
              "device": args.device,
              "settings": {k: list(v) if isinstance(v, tuple) else v
                           for k, v in kw.items()}}
    with tempfile.TemporaryDirectory() as tmp:
        tr = {name: cc.build_trainer(
            "FCOS", False, warmup_steps=0, tmpdir=tmp, device=dev,
            compute_dtype=DTYPES[args.dtype], **kw)
            for name, dev in devs.items()}

        # 1. the first step's gradients
        first = next(iter(tr["cpu"].train_loader.epoch()))
        l_cpu, g_cpu = grads(tr["cpu"].model, first)
        l_card, g_card = grads(tr["card"].model, first)
        rel = {n: float((g_card[n] - g).abs().max()
                        / max(float(g.abs().max()), 1e-30))
               for n, g in g_cpu.items()}
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:8]
        print(f"first step: loss cpu {l_cpu:.6f} card {l_card:.6f}")
        for n, r in worst:
            print(f"  grad {n}: max |card - cpu| / max |cpu| = {r:.3g}")
        result["first_step"] = {"loss_cpu": l_cpu, "loss_card": l_card,
                                "worst_grad_rel": worst}

        # 2. lock step: the same batch on both devices at every step
        losses = []
        batches = iter(())
        for step in range(args.steps):
            batch = next(batches, None)
            if batch is None:
                batches = iter(tr["cpu"].train_loader.epoch())
                batch = next(batches)
            pair = []
            for name, t in tr.items():
                placed = {k: to_tensor(v, t.device) for k, v in batch.items()}
                t.opt_state, m = t.steps[0](t.opt_state, placed, None, 1.0)
                pair.append(round(float(m["loss"]), 5))
            losses.append(pair)
            print(f"step {step}: loss cpu {pair[0]:.5f} card {pair[1]:.5f}",
                  flush=True)
        result["losses_cpu_card"] = losses

        # 3. each device's weights evaluated on both devices
        maps = {}
        weights = {name: {k: v.detach().cpu().clone()
                          for k, v in t.model.state_dict().items()}
                   for name, t in tr.items()}
        for trained, sd in weights.items():
            for evaluator, t in tr.items():
                t.model.load_state_dict(sd)
                maps[f"{trained}_weights_on_{evaluator}"] = round(
                    float(t.validate()["map_50"]), 4)
        print(f"train mAP@0.5: {maps}")
        result["map_50"] = maps
    print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
