"""Weights from elsewhere into the port: a torchvision checkpoint (the
reference's warm start) and the JAX model's parameter tree (the tests).

**torchvision** (the port's own copy of dgod_tpu/utils/weights.py's
converters). A checkpoint of the models the reference builds
(`fasterrcnn_resnet50_fpn` COCO, reference fasterrcnn.py:307-329;
`fcos_resnet50_fpn`, fcos.py:717-788; a plain ImageNet `resnet50`, the FCOS
factory's backbone init, fcos.py:776-783) maps straight onto the port's
`state_dict` names, relative to the detector:

- resnet: `layerL.B.convN` / `bnN` / `downsample.{0,1}` ->
  `layerL_blockB.Conv_{N-1}` / `bnN` / `downsample_conv` / `downsample_bn`;
  the stem `conv1.weight` goes in as it is (the port's stem is the plain
  7x7/2 conv);
- FrozenBatchNorm `weight/bias/running_mean/running_var` ->
  `scale/bias/mean/var`;
- FPN `inner_blocks.i` / `layer_blocks.i` (with or without torchvision
  0.13's `.0.` nesting) -> `lateral{i}` / `output{i}`; FCOS's P6/P7 extra
  blocks -> `p6p7.p6` / `p6p7.p7`;
- the heads by the name tables below: both spellings of the RPN conv
  (`rpn.head.conv` and `rpn.head.conv.0.0`), FCOS's GroupNorm towers
  (`conv.{0,3,6,9}` convs, `{1,4,7,10}` GroupNorms).

Conv kernels stay OIHW and dense weights `[out, in]`: the port has torch's
layout, so nothing is transposed. fc6's input is permuted CHW -> HWC: torch
flattens the pooled 256x7x7 RoI patch CHW, the port flattens it HWC.

`port_torchvision` is the audited entry point: it raises on any source key
it did not consume (a renamed upstream key never skips silently), on any
converted tensor with no destination and on any shape mismatch, except in
the class-dependent final layers, which are dropped and reported when
their shapes differ (the reference swaps `box_predictor` after loading
COCO weights, fasterrcnn.py:325-327) and keep the model's own init.

**JAX.** `params_from_jax(tree)` takes the parameter tree of a JAX
DGFRCNNModel or DGFCOSModel as nested dicts of numpy arrays (e.g.
`jax.tree.map(np.asarray, params)`) and returns the port's `state_dict`:
the port's parameter names are the tree's paths joined with '.', with
`kernel` renamed `weight`.

- conv kernels: HWIO -> OIHW;
- dense kernels: [in, out] -> [out, in] (fc6 included: both models flatten
  the pooled RoI patch HWC, so it is a plain transpose);
- DomainBank kernels `bank/fc{i}/kernel` [D, in, out] keep their layout;
- FrozenBatchNorm `scale/bias/mean/var` become the port's buffers;
- GroupNorm `scale/bias` (the FCOS head) are the port's trainable
  parameters of the same names.

Every leaf is used; an unknown leaf raises.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Set

import numpy as np
import torch

TOP_LEVEL = ("detector", "image_da", "ins_da", "ins_cls", "ins_cls_prime")
BN_LEAVES = ("scale", "mean", "var")

# source keys a torchvision state_dict carries that have no destination:
# BN step counters (unused by FrozenBatchNorm) and the classifier of a
# plain ImageNet resnet50 (the detectors keep only its body)
IGNORABLE = re.compile(r"(num_batches_tracked$)|(^fc\.(weight|bias)$)")

_BN_PARAM = {"weight": "scale", "bias": "bias",
             "running_mean": "mean", "running_var": "var"}

# final layers whose shapes depend on the class count: a COCO FRCNN
# checkpoint's predictor has 91 classes (the port's 10), an FCOS COCO
# cls_logits 91 outputs (the port's 9)
_CLASS_DEPENDENT = {"FRCNN": ("predictor",), "FCOS": ("head.cls_logits",)}


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def _convert_resnet_body(sd, prefix: str, out: Dict, dst: str,
                         consumed: Set[str]) -> None:
    """`{prefix}layerL.B.*` etc. -> `{dst}.layerL_blockB.*` in `out`."""
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        last = rest.split(".")[-1]
        name = None
        m = re.match(r"layer(\d)\.(\d+)\.(.*)", rest)
        if m:
            base = f"{dst}.layer{int(m.group(1))}_block{int(m.group(2))}"
            tail = m.group(3)
            if re.fullmatch(r"conv\d\.weight", tail):
                name = f"{base}.Conv_{int(tail[4]) - 1}.weight"
            elif tail.startswith("bn") and last in _BN_PARAM:
                name = f"{base}.bn{tail[2]}.{_BN_PARAM[last]}"
            elif tail == "downsample.0.weight":
                name = f"{base}.downsample_conv.weight"
            elif tail.startswith("downsample.1") and last in _BN_PARAM:
                name = f"{base}.downsample_bn.{_BN_PARAM[last]}"
        elif rest == "conv1.weight":
            name = f"{dst}.conv1.weight"
        elif rest.startswith("bn1.") and last in _BN_PARAM:
            name = f"{dst}.bn1.{_BN_PARAM[last]}"
        if name is not None:
            out[name] = _as_tensor(val)
            consumed.add(key)


def _convert_fpn(sd, prefix: str, out: Dict, dst: str,
                 consumed: Set[str]) -> None:
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        for src, ours in (("inner_blocks", "lateral"),
                          ("layer_blocks", "output")):
            m = re.match(src + r"\.(\d+)\.(?:0\.)?(weight|bias)$", rest)
            if m:
                out[f"{dst}.{ours}{int(m.group(1))}.{m.group(2)}"] = \
                    _as_tensor(val)
                consumed.add(key)


def _take(sd, out: Dict, consumed: Set[str], pairs) -> None:
    """Copy `sd[src]` to `out[dst]` for each (src, dst) present."""
    for src, dst in pairs:
        if src in sd:
            out[dst] = _as_tensor(sd[src])
            consumed.add(src)


def convert_imagenet_resnet_state_dict(
        sd: Mapping, consumed: Optional[Set[str]] = None) -> Dict:
    """Plain torchvision resnet50 (ImageNet) -> the backbone body; `fc.*`
    is not consumed (IGNORABLE)."""
    consumed = set() if consumed is None else consumed
    out: Dict = {}
    _convert_resnet_body(sd, "", out, "backbone.body", consumed)
    return out


def convert_frcnn_state_dict(sd: Mapping,
                             consumed: Optional[Set[str]] = None) -> Dict:
    """torchvision fasterrcnn_resnet50_fpn -> the port's FRCNNDetector."""
    consumed = set() if consumed is None else consumed
    out: Dict = {}
    _convert_resnet_body(sd, "backbone.body.", out, "backbone.body", consumed)
    _convert_fpn(sd, "backbone.fpn.", out, "backbone.fpn", consumed)
    pairs = []
    for p in ("weight", "bias"):
        # newer torchvision nests the RPN conv as conv.0.0
        pairs += [(f"rpn.head.conv.{p}", f"rpn_head.conv.{p}"),
                  (f"rpn.head.conv.0.0.{p}", f"rpn_head.conv.{p}")]
        for layer in ("cls_logits", "bbox_pred"):
            pairs.append((f"rpn.head.{layer}.{p}", f"rpn_head.{layer}.{p}"))
        for layer in ("fc6", "fc7"):
            pairs.append((f"roi_heads.box_head.{layer}.{p}",
                          f"box_head.{layer}.{p}"))
        for layer in ("cls_score", "bbox_pred"):
            pairs.append((f"roi_heads.box_predictor.{layer}.{p}",
                          f"predictor.{layer}.{p}"))
    _take(sd, out, consumed, pairs)
    if "box_head.fc6.weight" in out:
        w = out["box_head.fc6.weight"]  # [1024, 256*7*7], input CHW
        out["box_head.fc6.weight"] = (w.reshape(w.shape[0], 256, 7, 7)
                                      .permute(0, 2, 3, 1)
                                      .reshape(w.shape[0], -1).contiguous())
    return out


def convert_fcos_state_dict(sd: Mapping,
                            consumed: Optional[Set[str]] = None) -> Dict:
    """torchvision fcos_resnet50_fpn -> the port's FCOS detector."""
    consumed = set() if consumed is None else consumed
    out: Dict = {}
    _convert_resnet_body(sd, "backbone.body.", out, "backbone.body", consumed)
    _convert_fpn(sd, "backbone.fpn.", out, "backbone.fpn", consumed)
    pairs = []
    for p in ("weight", "bias"):
        for lvl in ("p6", "p7"):
            pairs.append((f"backbone.fpn.extra_blocks.{lvl}.{p}",
                          f"backbone.p6p7.{lvl}.{p}"))
        # towers: conv.{0,3,6,9} convs, {1,4,7,10} GroupNorms (reference
        # fcos.py:226-233, 300-307: Conv2d, GroupNorm, ReLU per layer)
        for tower, ours in (("classification_head", "cls"),
                            ("regression_head", "reg")):
            for i in range(4):
                pairs.append((f"head.{tower}.conv.{3 * i}.{p}",
                              f"head.{ours}_conv{i}.{p}"))
                pairs.append((f"head.{tower}.conv.{3 * i + 1}.{p}",
                              f"head.{ours}_gn{i}."
                              + ("scale" if p == "weight" else "bias")))
        for src, dst in (("classification_head.cls_logits", "cls_logits"),
                         ("regression_head.bbox_reg", "bbox_reg"),
                         ("regression_head.bbox_ctrness", "bbox_ctrness")):
            pairs.append((f"head.{src}.{p}", f"head.{dst}.{p}"))
    _take(sd, out, consumed, pairs)
    return out


def unconsumed_keys(sd: Mapping, consumed: Set[str]) -> List[str]:
    """Source keys the converter did not map, minus the ignorable ones."""
    return sorted(k for k in sd
                  if k not in consumed and not IGNORABLE.search(k))


def port_torchvision(detector: torch.nn.Module, sd: Mapping,
                     family: str) -> Dict:
    """Copy a torchvision checkpoint into `detector`'s parameters and
    buffers, in place.

    `family`: 'FRCNN' | 'FCOS' | 'resnet' (a plain ImageNet resnet50: the
    backbone body only). Raises ValueError if a non-ignorable source key
    was not consumed, if a converted tensor has no destination, or on any
    shape mismatch outside the class-dependent final layers (those are
    dropped and reported when any of their shapes differs, and keep the
    model's init). -> {merged, dropped_class_dependent, total_leaves}.
    """
    consumed: Set[str] = set()
    converters = {"FRCNN": convert_frcnn_state_dict,
                  "FCOS": convert_fcos_state_dict,
                  "resnet": convert_imagenet_resnet_state_dict}
    if family not in converters:
        raise ValueError(f"unknown family {family!r}")
    converted = converters[family](sd, consumed)

    leftover = unconsumed_keys(sd, consumed)
    if leftover:
        raise ValueError(
            f"converter did not consume {len(leftover)} source keys "
            f"(renamed upstream?): {leftover[:8]}"
            f"{'...' if len(leftover) > 8 else ''}")

    dst = detector.state_dict()
    dropped = []
    for layer in _CLASS_DEPENDENT.get(family, ()):
        keys = [k for k in converted if k.startswith(layer + ".")]
        if any(k not in dst or tuple(converted[k].shape) != tuple(dst[k].shape)
               for k in keys):
            for k in keys:
                del converted[k]
            dropped.append(layer)

    missing = sorted(k for k in converted if k not in dst)
    if missing:
        raise ValueError(
            f"{len(missing)} converted tensors have no destination in the "
            f"model: {missing[:8]}{'...' if len(missing) > 8 else ''}")
    for k, v in converted.items():
        if tuple(v.shape) != tuple(dst[k].shape):
            raise ValueError(f"shape mismatch for {k}: {tuple(dst[k].shape)} "
                             f"vs {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in converted.items():
            dst[k].copy_(v)
    return {"merged": len(converted), "dropped_class_dependent": dropped,
            "total_leaves": len(dst)}


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A .pth/.pt state_dict (or a Lightning checkpoint) -> CPU tensors, the
    Lightning `state_dict` wrapper and its `model.`/`detector.` prefix
    stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {re.sub(r"^(model|detector)\.", "", k): _as_tensor(v)
            for k, v in obj.items()}


def torchvision_family(sd: Mapping, model_name: str) -> str:
    """The converter a checkpoint needs: the detector's own when it holds
    a detector (`backbone.*` keys), else a plain ImageNet 'resnet'."""
    return (model_name if any(k.startswith("backbone.") for k in sd)
            else "resnet")


def _walk(tree: Mapping, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _walk(val, path)
        else:
            yield path, val


def jax_leaf_key(path) -> str:
    """A JAX parameter's path -> its state_dict key in the port."""
    leaf, name = path[-1], ".".join(path[:-1])
    if leaf == "kernel":
        return f"{name}.weight"
    if leaf == "bias" or leaf in BN_LEAVES:
        return f"{name}.{leaf}"
    raise KeyError(f"params_from_jax: unknown leaf {'/'.join(path)}")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    unknown_top = set(tree) - set(TOP_LEVEL)
    if unknown_top:
        raise KeyError(f"params_from_jax: unknown top-level keys "
                       f"{sorted(unknown_top)}")
    out = {}
    for path, val in _walk(tree):
        arr = np.array(val, dtype=np.float32)  # a writable copy
        key = jax_leaf_key(path)
        if path[-1] == "kernel":
            if arr.ndim == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # dense [in, out] -> [out, in]
                arr = arr.T
            elif arr.ndim == 3 and "bank" in path:  # [D, in, out] as is
                pass
            else:
                raise ValueError(f"params_from_jax: unexpected kernel shape "
                                 f"{arr.shape} at {'/'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def opt_state_from_jax(tree: Mapping, names) -> Dict:
    """A JAX package optimizer state (dgod_tpu/train/optim.py: {} under
    SGD; Adam's `mu` and `nu` trees and a step count per leaf) -> the
    port's (train/optim.py), for the parameters `names`: the moments
    through `params_from_jax`, with its transposes, each count an int."""
    if not tree:
        return {}
    mu, nu = params_from_jax(tree["mu"]), params_from_jax(tree["nu"])
    count = {jax_leaf_key(path): int(np.asarray(v))
             for path, v in _walk(tree["count"])}
    return {"mu": {n: mu[n] for n in names}, "nu": {n: nu[n] for n in names},
            "count": {n: count[n] for n in names}}


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy a JAX parameter tree into `model`; every key on both sides must
    match (strict)."""
    sd = params_from_jax(tree)
    model.load_state_dict(sd, strict=True)
