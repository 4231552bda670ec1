#!/usr/bin/env python3
"""Per-stage roofline table of the detector trunk on one card (the port of
scripts/roofline_backbone.py).

    python3 scripts/roofline_backbone_torch.py [--family FRCNN|FCOS|both]
        [--iters 5]
    python3 scripts/roofline_backbone_torch.py --device cpu   # a smoke run

For the stem, each ResNet stage, each family's FPN and each family's head
row (the RPN's 3x3 conv at P2; FCOS's classification tower at P3, 4 x
conv + GroupNorm + relu), at 608x1216, batch 8, bf16 compute, this times
the port's own modules (`models/resnet.py`, `fpn.py`, the heads) forward
and forward+backward on the device (`utils/timing.device_time_ms`: CUDA
events around calls queued behind a device sleep) and sets the forward
against its bound:

    bound = max(flops / peak_flops, bytes / peak_bw)

- **flops**: the convolutions' 2*M*N*K per batch (`utils/flops.py`'s
  per-stage counts; the stem is the port's 7x7/2 conv), held here to
  `torch.utils.flop_counter.FlopCounterMode` over the stage's forward;
- **bytes**: the JAX script's unfused-conv-chain model, so the shares
  compare: each conv reads its input and weights and writes its output
  once, in bf16; batch-norm and relu fuse into the conv's epilogue; a
  residual add or an FPN merge reads two output-sized tensors and writes
  one. FrozenBatchNorm is a separate elementwise pass in the port but not
  in the model: the bound counts what the stage needs, and the time is
  what the port runs;
- **peaks**: the H100 SXM's dense bf16 rate (`utils/flops.py`, 989.4
  TFLOP/s) and its HBM3 rate, 3.35 TB/s.

forward+backward computes the gradients training computes: those of the
parameters `requires_grad` marks in training (not the frozen stem's and
layer1's: their rows have no backward), and that of the stage's input
where a trainable layer lies below it (layer3 up; not layer2's, whose
input comes from the frozen layer1, nor the FPN's C2). Its rate counts 3x
the forward FLOPs (forward, dX, dW), as `utils/flops.py` does.

Prints one JSON line: per stage ms, achieved TFLOP/s, bound ms, what
bounds it and the share (bound / ms), and the forward+backward's ms,
TFLOP/s and MFU. Without a card it exits non-zero and prints none, unless
`--device cpu` is given (64x128, blocks (1,1,1,1), batch 2, float32: a
check of the counts and the path; its times are the CPU's, and no share
is given).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = ("FRCNN", "FCOS")
BYTES = 2.0  # bf16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_bytes(h_in, w_in, h_out, w_out, k, cin, cout, batch):
    """Unfused traffic of one conv: read its input, write its output, read
    its weights (bf16)."""
    return (BYTES * (h_in * w_in * cin + h_out * w_out * cout) * batch
            + BYTES * k * k * cin * cout)


def stage_traffic(h_in, w_in, cin, width, count, stride, batch):
    """Traffic of a stack of `count` bottlenecks (the module docstring's
    model)."""
    total = 0.0
    h_out, w_out = h_in // stride, w_in // stride
    for i in range(count):
        hi, wi = (h_in, w_in) if i == 0 else (h_out, w_out)
        ci = cin if i == 0 else width * 4
        total += conv_bytes(hi, wi, hi, wi, 1, ci, width, batch)
        total += conv_bytes(hi, wi, h_out, w_out, 3, width, width, batch)
        total += conv_bytes(h_out, w_out, h_out, w_out, 1, width, width * 4,
                            batch)
        if i == 0:
            total += conv_bytes(hi, wi, h_out, w_out, 1, ci, width * 4,
                                batch)
        # residual add: read identity and main, write out
        total += 3 * BYTES * h_out * w_out * width * 4 * batch
    return total


def fpn_traffic(canvas, family: str, batch: int) -> float:
    """Traffic of the FPN: each level's lateral 1x1 and output 3x3 conv,
    each top-down merge (read the lateral and the upsampled level, write
    the sum), and the extra levels (FRCNN's 1x1/2 max pool reads and
    writes the pooled level; FCOS's P6 and P7 3x3/2 convs)."""
    H, W = canvas
    c_ch = {4: 256, 8: 512, 16: 1024, 32: 2048}
    strides = (4, 8, 16, 32) if family == "FRCNN" else (8, 16, 32)
    total = 0.0
    for s in strides:
        h, w = _cdiv(H, s), _cdiv(W, s)
        total += conv_bytes(h, w, h, w, 1, c_ch[s], 256, batch)
        total += conv_bytes(h, w, h, w, 3, 256, 256, batch)
    for s in strides[:-1]:
        total += 3 * BYTES * _cdiv(H, s) * _cdiv(W, s) * 256 * batch
    if family == "FRCNN":
        total += 2 * BYTES * _cdiv(H, 64) * _cdiv(W, 64) * 256 * batch
    else:
        for s in (64, 128):
            total += conv_bytes(_cdiv(H, s // 2), _cdiv(W, s // 2),
                                _cdiv(H, s), _cdiv(W, s), 3, 256, 256, batch)
    return total


def stage_table(family: str, canvas, batch: int, blocks=(3, 4, 6, 3),
                backbone: bool = True):
    """The rows of one family: [{name, family (None for the backbone's,
    which both families share), inputs (NCHW shapes), flops, bytes}] per
    batch; the backbone's rows (stem, layer1-4) only with `backbone`."""
    from dgod_tpu_torch.utils import flops as F

    H, W = canvas
    h2, w2 = _cdiv(H, 2), _cdiv(W, 2)
    h4, w4 = _cdiv(h2, 2), _cdiv(w2, 2)
    rows = []
    if backbone:
        bb = F.resnet50_flops(canvas, blocks)
        rows.append({"name": "stem (7x7/2 conv + pool)", "family": None,
                     "inputs": [(batch, 3, H, W)],
                     "flops": bb["stem"] * batch,
                     "bytes": conv_bytes(H, W, h2, w2, 7, 3, 64, batch)
                     + BYTES * h2 * w2 * 64 * batch})
        h, w, cin = h4, w4, 64
        for s, (count, width) in enumerate(zip(blocks, (64, 128, 256, 512)),
                                           start=1):
            stride = 1 if s == 1 else 2
            rows.append({"name": f"layer{s} ({count}x w{width} "
                                 f"s{4 * 2 ** (s - 1)})", "family": None,
                         "inputs": [(batch, cin, h, w)],
                         "flops": bb[f"layer{s}"] * batch,
                         "bytes": stage_traffic(h, w, cin, width, count,
                                                stride, batch)})
            h, w, cin = h // stride, w // stride, width * 4
    levels = (4, 8, 16, 32) if family == "FRCNN" else (8, 16, 32)
    c_ch = {4: 256, 8: 512, 16: 1024, 32: 2048}
    rows.append({"name": f"{family} FPN", "family": family,
                 "inputs": [(batch, c_ch[s], _cdiv(H, s), _cdiv(W, s))
                            for s in levels],
                 "flops": F.fpn_flops(canvas, family) * batch,
                 "bytes": fpn_traffic(canvas, family, batch)})
    if family == "FRCNN":
        rows.append({"name": "rpn conv @P2", "family": family,
                     "inputs": [(batch, 256, h4, w4)],
                     "flops": F.conv_flops(h4, w4, 3, 3, 256, 256) * batch,
                     "bytes": conv_bytes(h4, w4, h4, w4, 3, 256, 256,
                                         batch)})
    else:
        h8, w8 = _cdiv(H, 8), _cdiv(W, 8)
        rows.append({"name": "fcos tower @P3 (4conv)", "family": family,
                     "inputs": [(batch, 256, h8, w8)],
                     "flops": 4 * F.conv_flops(h8, w8, 3, 3, 256, 256)
                     * batch,
                     "bytes": 4 * conv_bytes(h8, w8, h8, w8, 3, 256, 256,
                                             batch)})
    return rows


def stage_fns(model):
    """The port's modules behind each row of `stage_table`, in its order:
    [(fn(*inputs) -> output tensor or list, the modules it runs, whether
    the gradient of each input is one training computes)]."""
    import torch.nn.functional as Fn

    from dgod_tpu_torch.models.fpn import last_level_max_pool

    det = model.detector
    body, fpn = det.backbone.body, det.backbone.fpn
    out = []

    def stem(x):
        return Fn.max_pool2d(Fn.relu(body.bn1(body.conv1(x))), 3, 2, 1)

    out.append((stem, [body.conv1, body.bn1], [False]))
    for s, count in enumerate(body.block_counts, start=1):
        blocks = [getattr(body, f"layer{s}_block{i}") for i in range(count)]

        def stage(x, blocks=blocks):
            for b in blocks:
                x = b(x)
            return x

        # layer3 up: the input's gradient flows into a trainable layer
        out.append((stage, blocks, [s >= 3]))
    if model.name == "FRCNN":
        def pyramid(*c):
            ps = fpn(list(c))
            return ps + [last_level_max_pool(ps[-1])]

        out.append((pyramid, [fpn], [False, True, True, True]))
        head = det.rpn_head
        out.append((lambda x: Fn.relu(head.conv(x)), [head.conv], [True]))
    else:
        p6p7 = det.backbone.p6p7

        def pyramid(*c):
            ps = fpn(list(c))
            return ps + list(p6p7(ps[-1]))

        out.append((pyramid, [fpn, p6p7], [True, True, True]))
        head = det.head
        convs = [getattr(head, f"cls_{k}{i}") for i in range(head.num_convs)
                 for k in ("conv", "gn")]
        out.append((lambda x: head._tower("cls", x), convs, [True]))
    return out


def measure_family(family: str, dev, size: dict, iters: int,
                   backbone: bool) -> list:
    """The rows of one family on `dev`, measured."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel
    from dgod_tpu_torch.utils import flops as F
    from dgod_tpu_torch.utils import timing

    cls = {"FRCNN": DGFRCNNModel, "FCOS": DGFCOSModel}[family]
    model = cls(num_classes=9, num_domains=3, canvas=size["canvas"],
                compute_dtype=size["dtype"],
                backbone_block_counts=size["blocks"], device=dev, seed=0)
    labels = model.param_group_labels()
    trainable = {id(p) for n, p in model.named_parameters()
                 if labels[n] != "frozen"}
    table = stage_table(family, size["canvas"], size["batch"],
                        size["blocks"], backbone)
    fns = stage_fns(model)
    if not backbone:
        fns = fns[-2:]
    gen = torch.Generator(device=dev).manual_seed(0)
    cuda = dev.type == "cuda"
    rows = []
    for row, (fn, mods, input_grads) in zip(table, fns):
        # NCHW in channels_last memory, as the model's convs see them
        xs = [torch.randn((s[0], s[2], s[3], s[1]), generator=gen,
                          device=dev).to(size["dtype"]).permute(0, 3, 1, 2)
              for s in row["inputs"]]
        params = [p for m in mods for p in m.parameters()
                  if id(p) in trainable]
        with torch.no_grad():
            with FlopCounterMode(display=False) as counter:
                fn(*xs)
            counted = counter.get_total_flops()
            if counted != row["flops"]:
                raise SystemExit(
                    f"roofline_backbone_torch: {row['name']}: the count "
                    f"says {row['flops']:.6g} FLOPs, FlopCounterMode "
                    f"{counted:.6g}")
            ms = timing.device_time_ms(lambda: fn(*xs), dev, iters=iters,
                                       warmup=1)
        fb_ms = None
        if params:
            ins = [x.detach().requires_grad_(g)
                   for x, g in zip(xs, input_grads)]
            wrt = params + [x for x in ins if x.requires_grad]
            outs = fn(*ins)
            outs = outs if isinstance(outs, list) else [outs]
            grads_out = [torch.ones_like(o) for o in outs]
            del outs

            def fwd_bwd():
                outs = fn(*ins)
                outs = outs if isinstance(outs, list) else [outs]
                return torch.autograd.grad(outs, wrt, grads_out)

            fb_ms = timing.device_time_ms(fwd_bwd, dev, iters=iters,
                                          warmup=1)
        t_flops = row["flops"] / F.H100_SXM_BF16_PEAK_FLOPS * 1e3
        t_bytes = row["bytes"] / F.H100_SXM_HBM_BYTES_PER_S * 1e3
        bound = max(t_flops, t_bytes)
        rows.append({
            "name": row["name"], "family": row["family"],
            "inputs": [list(s) for s in row["inputs"]],
            "gflops": row["flops"] / 1e9, "gbytes": row["bytes"] / 1e9,
            "flop_counter_gflops": counted / 1e9,
            "ms": ms, "tflops": row["flops"] / ms / 1e9,
            "bound_ms": bound,
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "share": bound / ms if cuda else None,
            "trainable": bool(params),
            "fwd_bwd_ms": fb_ms,
            "fwd_bwd_tflops": (3 * row["flops"] / fb_ms / 1e9
                               if fb_ms else None),
            "fwd_bwd_mfu": (3 * row["flops"] / (fb_ms / 1e3)
                            / F.H100_SXM_BF16_PEAK_FLOPS
                            if fb_ms and cuda else None),
        })
        del xs
    del model
    return rows


def run(args, dev) -> dict:
    """The table of `args` on `dev`. -> the JSON line's object."""
    from dgod_tpu_torch.utils import flops as F
    from dgod_tpu_torch.utils import synthetic, timing

    size = synthetic.SIZES[dev.type]
    families = FAMILIES if args.family == "both" else (args.family,)
    rows = []
    for i, family in enumerate(families):
        rows += measure_family(family, dev, size, args.iters,
                               backbone=i == 0)
    return {
        "script": "roofline_backbone_torch",
        "stages": rows,
        "canvas": list(size["canvas"]), "batch": size["batch"],
        "block_counts": list(size["blocks"]),
        "dtype": str(size["dtype"]).replace("torch.", ""),
        "peak_tflops": F.H100_SXM_BF16_PEAK_FLOPS / 1e12,
        "peak_tbytes_per_s": F.H100_SXM_HBM_BYTES_PER_S / 1e12,
        "iters": args.iters, **timing.describe(dev),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--family", default="both",
                        choices=("FRCNN", "FCOS", "both"))
    parser.add_argument("--iters", type=int, default=5,
                        help="timed calls per stage, forward and "
                             "forward+backward")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (a smoke run)")
    args = parser.parse_args(argv)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("roofline_backbone_torch: no CUDA device; pass --device cpu "
              "for a smoke run", file=sys.stderr)
        return 1
    print(json.dumps(run(args, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
