#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card, at the
cell's own sizes, many seeds in one process:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
        [--sides program,fp8,half] [--seconds 2] [--out FILE]

For each seed the cell's set-up runs as in a run of perfbench/run.py (the
program's model, its first DG cycle or its warm requests), then:
- `program`: the program's readings against the reference's, as a run's
  check compares them (for a predict cell, after a window of `--seconds`);
- `fp8`: the precision control, the reference computed on fp8 operands
  (e4m3 forward, e5m2 gradients, scaled per tensor), the nearest precision
  below the configuration's bfloat16, put in the program's place;
- `half`: (training) a planted fault, the reference on half of each batch
  with the mean taken over the rest, in the program's place;
- `f32`: a witness, the reference computing in float32 put in the
  program's place: how far the configuration's own precision lies from
  float32;
- `self`, `ulp`: (training) witnesses of the reference against itself, run
  again as it is, and from weights moved by one ulp each: how far the
  readings move with rounding alone, with none of the program's kernels.
Prints one JSON line per seed and side (and appends it to --out). The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ulp_state(state: dict, seed: int) -> dict:
    """`state` with every float32 parameter moved by one ulp, up or down
    at random from the seed (a witness of how far rounding alone carries
    the readings)."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(3 * seed + 7)
    out = {}
    for name in sorted(state):
        t = state[name]
        up = (torch.rand(t.shape, generator=gen) < 0.5).to(t.device)
        far = torch.where(up, torch.full_like(t, float("inf")),
                          torch.full_like(t, float("-inf")))
        out[name] = torch.nextafter(t, far)
    return out


def readings(cell: dict, seed: int, sides, seconds: float, device) -> list:
    import numpy as np
    import torch

    from perfbench.bench import compare, predict, train
    from perfbench.bench.common import Spans

    kind = cell["traffic"]["kind"]
    out = []
    t0 = time.perf_counter()
    if kind == "train":
        cell = dict(cell, traffic=dict(cell["traffic"], warm_cycles=0))
        s = train.setup(cell, seed, device, Spans(False))
        prog = s.readings
        train.release(s)
        torch.cuda.empty_cache()
        ref = train.reference_readings(s.config, device, s.state, s.plan)
        others = {
            "program": lambda: prog,
            "fp8": lambda: train.reference_readings(
                s.config, device, s.state, s.plan, fp8=True),
            "half": lambda: train.reference_readings(
                s.config, device, s.state, s.plan,
                rows=s.batch // 2),
            "f32": lambda: train.reference_readings(
                s.config, device, s.state, s.plan, dtype=torch.float32),
            "self": lambda: train.reference_readings(
                s.config, device, s.state, s.plan),
            "ulp": lambda: train.reference_readings(
                s.config, device, ulp_state(s.state, seed), s.plan),
        }
        for side in sides:
            t = time.perf_counter()
            got = others[side]()
            numbers = compare.train_numbers(got, ref)
            out.append(dict(seed=seed, side=side, numbers=numbers,
                            seconds=time.perf_counter() - t,
                            losses=got["losses"], ref_losses=ref["losses"],
                            worst_g1=compare.worst_leaves(got, ref, "g1"),
                            worst_d3=compare.worst_leaves(got, ref, "d3")))
    else:
        s = predict.setup(cell, seed, device, Spans(False))
        w = predict.window(s, seconds, Spans(False))
        predict.release(s)
        torch.cuda.empty_cache()
        for side in sides:
            t = time.perf_counter()
            if side == "program":
                numbers = predict.judge(s.config, device, s.state,
                                        s.requests, s.answers)
                views = predict.reference_views(s.config, device, s.state,
                                                s.requests, s.answers)
                worst = []
                for j, a in s.answers[:len(s.requests) * 4]:
                    r = views[j, predict.answer_key(a)]["rescored"]
                    v = a["valid"].reshape(-1)
                    g = np.nan_to_num(np.abs(a["scores"].reshape(-1)
                                             - r.reshape(-1))) * v
                    i = int(g.argmax())
                    worst.append((float(g[i]), j, a["boxes"].reshape(-1, 4)[
                        i].tolist(), int(a["labels"].reshape(-1)[i]),
                        float(a["scores"].reshape(-1)[i]),
                        float(r.reshape(-1)[i])))
                numbers["worst_detections"] = sorted(worst)[-3:]
                numbers["judged_share"] = float(np.mean([
                    np.isfinite(views[j, predict.answer_key(a)]["rescored"][
                        a["valid"]]).mean() for j, a in s.answers]))
                numbers["distinct_answers"] = len(views)
                numbers["served"] = [int(a["valid"].sum())
                                     for _, a in s.answers[:len(s.requests)]]
            elif side == "fp8":
                # the control serves its own detections, which the
                # reference then judges as it judges the program's
                own = predict.reference_detections(
                    s.config, device, s.state, s.requests, fp8=True)
                numbers = predict.judge(s.config, device, s.state,
                                        s.requests, list(enumerate(own)))
            elif side == "f32":
                own = predict.reference_detections(
                    s.config, device, s.state, s.requests,
                    dtype=torch.float32)
                numbers = predict.judge(s.config, device, s.state,
                                        s.requests, list(enumerate(own)))
            else:
                raise ValueError(f"no side {side!r} for a predict cell")
            out.append(dict(seed=seed, side=side, numbers=numbers,
                            requests=w["attempted"],
                            seconds=time.perf_counter() - t))
    for line in out:
        line["setup_and_reference_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,fp8,half,f32")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from perfbench.bench import common

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = common.load_cell(args.workload)
    sides = args.sides.split(",")
    if cell["traffic"]["kind"] == "predict":
        sides = [s for s in sides if s != "half"]
    for seed in (int(x) for x in args.seeds.split(",")):
        for line in readings(cell, seed, sides, args.seconds, device):
            line["workload"] = args.workload
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
