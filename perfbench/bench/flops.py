"""Analytic FLOP counts and MFU of the DG training cycle, both families: a
frozen copy of dgod_tpu_torch/utils/flops.py, held to it by
perfbench/tests/test_perfbench_frozen.py, so that the benchmark's mfu
metrics read the same model FLOPs whatever later changes make of the
program's copy.

Conventions, as in the JAX package:
- only convolutions and dense layers count, at 2*M*N*K FLOPs; elementwise
  ops, normalisations, RoIAlign, NMS and the matchers do not ("model
  FLOPs");
- backward is 3x forward (forward, dX, dW) for the trainable convs and
  denses, 1x (forward only) for the frozen stem and layer1, whose backward
  is never built (train/steps.py::stop_inactive_grads);
- per mode over the DG cycle (0,1,0,2,0,3,0,4): modes 0/1/3/4 pay the
  detector's forward and trainable backward, mode 2 (detector frozen) its
  forward only; the DG heads count where they run. FCOS's modes 1-4
  consume the head's input features only, so the FCOS head counts in mode
  0 alone: the port's eager forward still computes it in modes 1-4 and
  discards it (ROADMAP, perf_opt), which `fcos_head_flops` measures.

Two differences from the JAX count:
- **the stem is counted as the port runs it**, a 7x7x3 conv at stride 2;
  the JAX package counts its space-to-depth rewrite, a 4x4x12 conv at
  stride 1 over the half-size image (~31% more);
- **the peak is the H100 SXM's dense bf16 tensor-core rate**, 989.4
  TFLOP/s (NVIDIA H100 Tensor Core GPU datasheet, SXM5, without
  sparsity), not a TPU v5e's; `train_mfu` takes another as `peak_flops`.
"""

from __future__ import annotations

from typing import Dict, Tuple

H100_SXM_BF16_PEAK_FLOPS = 989.4e12
# the H100 SXM's HBM3 rate (same datasheet), the memory side of a bound
H100_SXM_HBM_BYTES_PER_S = 3.35e12


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def conv_flops(h: int, w: int, kh: int, kw: int, cin: int, cout: int) -> float:
    """One conv at output resolution h x w, per image: 2*HW*K*K*Cin*Cout."""
    return 2.0 * h * w * kh * kw * cin * cout


def dense_flops(n: int, cin: int, cout: int) -> float:
    return 2.0 * n * cin * cout


def resnet50_flops(canvas: Tuple[int, int],
                   block_counts=(3, 4, 6, 3)) -> Dict[str, float]:
    """Per-image forward FLOPs by component. Keys: stem, layer1..layer4."""
    H, W = canvas
    out = {}
    h, w = _ceil_div(H, 2), _ceil_div(W, 2)
    out["stem"] = conv_flops(h, w, 7, 7, 3, 64)  # 7x7/2 over 3 channels
    h, w = _ceil_div(h, 2), _ceil_div(w, 2)  # maxpool /2

    cin = 64
    widths = (64, 128, 256, 512)
    for stage, (count, width) in enumerate(zip(block_counts, widths), start=1):
        f = 0.0
        for i in range(count):
            stride = 2 if (i == 0 and stage > 1) else 1
            h_in, w_in = h, w
            if stride == 2:
                h, w = _ceil_div(h, 2), _ceil_div(w, 2)
            f += conv_flops(h_in, w_in, 1, 1, cin, width)       # 1x1 reduce
            f += conv_flops(h, w, 3, 3, width, width)           # 3x3 (stride)
            f += conv_flops(h, w, 1, 1, width, width * 4)       # 1x1 expand
            if i == 0:
                f += conv_flops(h, w, 1, 1, cin, width * 4)     # downsample
            cin = width * 4
        out[f"layer{stage}"] = f
    return out


def fpn_flops(canvas, family: str) -> float:
    """Per-image FPN forward FLOPs (laterals + 3x3 outputs [+ P6/P7])."""
    c_channels = {4: 256, 8: 512, 16: 1024, 32: 2048}
    strides = (4, 8, 16, 32) if family == "FRCNN" else (8, 16, 32)
    f = 0.0
    for s in strides:
        h, w = _ceil_div(canvas[0], s), _ceil_div(canvas[1], s)
        f += conv_flops(h, w, 1, 1, c_channels[s], 256)  # lateral
        f += conv_flops(h, w, 3, 3, 256, 256)            # output conv
    if family == "FCOS":
        for s in (64, 128):  # P6 (from P5), P7 (from P6): 3x3 stride-2
            h, w = _ceil_div(canvas[0], s), _ceil_div(canvas[1], s)
            f += conv_flops(h, w, 3, 3, 256, 256)
    return f


def fcos_head_flops(canvas, num_classes=9) -> float:
    """Per-image FCOS head forward: two 4-conv towers + 3 predictors over
    P3..P7 (models/fcos.py::FCOSHead)."""
    f = 0.0
    for s in (8, 16, 32, 64, 128):
        h, w = _ceil_div(canvas[0], s), _ceil_div(canvas[1], s)
        f += 8 * conv_flops(h, w, 3, 3, 256, 256)       # cls + reg towers
        f += conv_flops(h, w, 3, 3, 256, num_classes)   # cls logits
        f += conv_flops(h, w, 3, 3, 256, 4)             # bbox reg
        f += conv_flops(h, w, 3, 3, 256, 1)             # ctrness
    return f


def rpn_head_flops(canvas, num_anchors=3) -> float:
    """Per-image RPN head forward over P2..P5+pool (faster_rcnn.py)."""
    f = 0.0
    for s in (4, 8, 16, 32, 64):
        h, w = _ceil_div(canvas[0], s), _ceil_div(canvas[1], s)
        f += conv_flops(h, w, 3, 3, 256, 256)
        f += conv_flops(h, w, 1, 1, 256, num_anchors)
        f += conv_flops(h, w, 1, 1, 256, 4 * num_anchors)
    return f


def box_head_flops(num_rois: int, num_classes=9) -> float:
    """Per-image box head: fc6/fc7 on 7x7x256 RoI features + predictor."""
    feat = 7 * 7 * 256
    f = dense_flops(num_rois, feat, 1024)
    f += dense_flops(num_rois, 1024, 1024)
    f += dense_flops(num_rois, 1024, num_classes + 1)
    f += dense_flops(num_rois, 1024, 4 * (num_classes + 1))
    return f


def _valid_out(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


def dg_head_flops(family: str, canvas, num_domains=3, num_classes=9,
                  num_rois=512) -> Dict[str, float]:
    """Per-image DG auxiliary head forward FLOPs (models/dg_heads.py).

    The image-level heads zero-pad their input up to the smallest spatial
    size that reduces to 1x1 through their VALID strided convs, so the conv
    resolutions below use the padded sizes.
    """
    out = {}
    if family == "FRCNN":
        # ImageDAFPN on P2 (padded to >= (87,171)): 4 VALID convs 256->256
        h = max(_ceil_div(canvas[0], 4), 87)
        w = max(_ceil_div(canvas[1], 4), 171)
        f = 0.0
        for (sh, sw) in ((2, 4), (4, 4), (4, 4), (3, 3)):
            h, w = _valid_out(h, 3, sh), _valid_out(w, 3, sw)
            f += conv_flops(h, w, 3, 3, 256, 256)
        f += (dense_flops(1, h * w * 256, 128)
              + dense_flops(1, 128, num_domains))
        out["image_da"] = f
        # InstanceDA / InsCls / InsClsPrime: MLPs on [N,1024] box features
        mlp = (dense_flops(num_rois, 1024, 512)
               + dense_flops(num_rois, 512, 256))
        out["ins_da"] = mlp + dense_flops(num_rois, 256, num_domains)
        out["ins_cls"] = mlp + dense_flops(num_rois, 256, num_classes)
    else:
        # ImageDA on C5 (padded to >= (19,35)): VALID convs
        # 2048->1024 s(2,4), 1024->512 s2, 512->256 s2 + denses
        h = max(_ceil_div(canvas[0], 32), 19)
        w = max(_ceil_div(canvas[1], 32), 35)
        h, w = _valid_out(h, 3, 2), _valid_out(w, 3, 4)
        f = conv_flops(h, w, 3, 3, 2048, 1024)
        h, w = _valid_out(h, 3, 2), _valid_out(w, 3, 2)
        f += conv_flops(h, w, 3, 3, 1024, 512)
        h, w = _valid_out(h, 3, 2), _valid_out(w, 3, 2)
        f += conv_flops(h, w, 3, 3, 512, 256)
        f += (dense_flops(1, h * w * 256, 128)
              + dense_flops(1, 128, num_domains))
        out["image_da"] = f
        # instance heads act on ins_feat [R_total, 256]
        r_total = sum(
            _ceil_div(canvas[0], s) * _ceil_div(canvas[1], s)
            for s in (8, 16, 32, 64, 128)
        )
        mlp = dense_flops(r_total, 256, 128)
        out["ins_da"] = mlp + dense_flops(r_total, 128, num_domains)
        out["ins_cls"] = (mlp + dense_flops(r_total, 128, 64)
                          + dense_flops(r_total, 64, num_classes))
    return out


def family_forward_flops(family: str, canvas, num_rois=512,
                         block_counts=(3, 4, 6, 3)) -> Dict[str, float]:
    """Per-image detector forward FLOPs split into frozen/trainable parts;
    `head` apart (FCOS's DG modes 1-4 do not need it)."""
    bb = resnet50_flops(canvas, block_counts)
    frozen = bb["stem"] + bb["layer1"]
    trunk = bb["layer2"] + bb["layer3"] + bb["layer4"]
    trunk += fpn_flops(canvas, family)
    if family == "FCOS":
        head = fcos_head_flops(canvas)
    else:
        head = rpn_head_flops(canvas) + box_head_flops(num_rois)
    return {"frozen": frozen, "trunk": trunk, "head": head, "backbone": bb}


def cycle_flops(family: str, canvas, batch: int, num_domains=3,
                num_rois=512, block_counts=(3, 4, 6, 3)) -> Dict[str, float]:
    """Total FLOPs of one 8-step DG mode cycle (0,1,0,2,0,3,0,4) at batch
    size `batch`, plus per-mode and component breakdowns (per image)."""
    fw = family_forward_flops(family, canvas, num_rois, block_counts)
    dg = dg_head_flops(family, canvas, num_domains=num_domains,
                       num_rois=num_rois)
    trunk_fb = fw["frozen"] + 3.0 * fw["trunk"]     # fwd + trainable bwd
    trunk_f = fw["frozen"] + fw["trunk"]            # fwd only
    head_fb, head_f = 3.0 * fw["head"], fw["head"]
    # FCOS's DG modes need no detector head; FRCNN's need box features
    aux_head_fb = head_fb if family == "FRCNN" else 0.0
    aux_head_f = head_f if family == "FRCNN" else 0.0
    per_mode = {
        0: trunk_fb + head_fb,
        1: trunk_fb + aux_head_fb + 3.0 * (dg["image_da"] + dg["ins_da"]),
        2: trunk_f + aux_head_f + 3.0 * dg["ins_cls"],  # detector frozen
        3: trunk_fb + aux_head_fb + 3.0 * dg["ins_cls"],
        # mode 4 scores every image with all D domains' (frozen) InsCls
        # heads: D x forward + D x dX (no dW)
        4: trunk_fb + aux_head_fb + 2.0 * num_domains * dg["ins_cls"],
    }
    cycle = sum(per_mode[m] for m in (0, 1, 0, 2, 0, 3, 0, 4)) * batch
    return {
        "per_mode_per_image": per_mode,
        "cycle": cycle,
        "images_per_cycle": 8 * batch,
        "forward": fw,
        "dg_heads": dg,
    }


def train_mfu(family: str, canvas, batch: int, images_per_sec: float,
              num_domains=3, num_rois=512,
              peak_flops: float = H100_SXM_BF16_PEAK_FLOPS
              ) -> Dict[str, float]:
    """MFU of the DG training cycle from a measured images/s."""
    c = cycle_flops(family, canvas, batch, num_domains, num_rois)
    flops_per_image = c["cycle"] / c["images_per_cycle"]
    tflops_per_sec = images_per_sec * flops_per_image / 1e12
    return {
        "flops_per_image": flops_per_image,
        "model_tflops_per_sec": tflops_per_sec,
        "mfu": tflops_per_sec * 1e12 / peak_flops,
        "peak_tflops": peak_flops / 1e12,
    }
