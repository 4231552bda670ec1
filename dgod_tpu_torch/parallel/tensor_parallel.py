"""Tensor parallelism of the detector heads over the mesh's 'model' axis.

In the JAX package XLA's automatic sharding (GSPMD) splits the layers that
`mesh.param_sharding` names and inserts the collectives; here they are
written out. Each split layer (Faster R-CNN's `box_head.fc6`/`fc7`, FCOS's
`head.cls_conv{i}`/`reg_conv{i}`) keeps only its slice of output features
(`Mesh.m`'s block of dim 0 of its weight and bias) and runs as

    gather_from_model(layer_local(copy_to_model(x)))

so everything downstream (the ReLU, FCOS's GroupNorm over all 256
channels) sees the full output, identical on every rank of the model
group. The local product is the plain `F.linear`/`F.conv2d` of the layer.

A checkpoint holds the full tensors: `gather_state` rebuilds them from the
slices, `shard_state` cuts a full state down to this rank's.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from ..models.layers import Conv, Dense
from .mesh import Mesh, param_sharding


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward sums the input's gradient over the model
    group (each rank's slice contributes its part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the output slices along `dim` forward; backward keeps
    this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.dim, ctx.index, ctx.size = dim, index, size
        # gather along the last dim of a contiguous view: a channels_last
        # NCHW tensor moved to NHWC needs no copy
        xt = x.movedim(dim, -1).contiguous()
        parts = [torch.empty_like(xt) for _ in range(size)]
        dist.all_gather(parts, xt, group=group)
        return torch.cat(parts, -1).movedim(-1, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.size
        return g.narrow(ctx.dim, ctx.index * n, n), None, None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return _GatherFromModel.apply(x, dim, mesh.model_group, mesh.m,
                                  mesh.model)


def _local(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    n = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.m * n, n).clone()


def shard_model(model: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Split the layers `param_sharding` names over the model group, in
    place: each keeps its local output slice and runs between
    `copy_to_model` and `gather_from_model`. Parameter names do not change.
    -> the sharding ({name: dim}); empty when the model axis is 1. A
    model whose backbone does not split over the model axis (ViTDet-B) is
    refused: only the heads would split, and its trunk would stay whole on
    every rank."""
    whole = [type(m).__name__ for m in model.modules()
             if not getattr(m, "splits_over_model_axis", True)]
    if mesh.model > 1 and whole:
        raise ValueError(f"tensor parallelism splits the ResNet-50 FPN "
                         f"detectors' head layers; {whole[0]} takes data "
                         f"parallelism alone (--mesh data=N)")
    sharding = param_sharding(model, mesh)
    layers = {name.rsplit(".", 1)[0] for name in sharding}
    for path in sorted(layers):
        layer = model.get_submodule(path)
        if not isinstance(layer, (Conv, Dense)):
            raise TypeError(f"{path}: tensor parallelism splits Conv and "
                            f"Dense layers, not {type(layer).__name__}")
        for pname in ("weight", "bias"):
            full = f"{path}.{pname}"
            p = getattr(layer, pname)
            if p is None:
                continue
            if full not in sharding:
                raise ValueError(f"{full} is not split with its layer")
            setattr(layer, pname, torch.nn.Parameter(
                _local(p.detach(), sharding[full], mesh),
                requires_grad=p.requires_grad))
        out_dim = 1 if isinstance(layer, Conv) else -1
        layer.split_over_model = True
        layer.register_forward_pre_hook(
            lambda mod, args: (copy_to_model(args[0], mesh),) + args[1:])
        layer.register_forward_hook(
            lambda mod, args, out, _d=out_dim: gather_from_model(out, _d,
                                                                 mesh))
    return sharding


def holds_split_layers(model: torch.nn.Module) -> bool:
    """Whether `shard_model` split any layer of `model` (its forward then
    runs collectives)."""
    return any(getattr(m, "split_over_model", False)
               for m in model.modules())


def shard_state(state, sharding: Dict[str, int], mesh: Mesh):
    """A full state (a state_dict, or the optimizer state's per-parameter
    dicts) cut down to this rank's slices of the split parameters."""
    if isinstance(state, dict):
        return {k: (_local(v, sharding[k], mesh) if k in sharding
                    and isinstance(v, torch.Tensor) else
                    shard_state(v, sharding, mesh)) for k, v in state.items()}
    return state


def gather_state(state, sharding: Dict[str, int], mesh: Mesh):
    """The full tensors of a sharded state (`shard_state`'s inverse), on
    every rank of the model group; a collective over it."""
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            if k in sharding and isinstance(v, torch.Tensor):
                parts = [torch.empty_like(v) for _ in range(mesh.model)]
                dist.all_gather(parts, v.contiguous(),
                                group=mesh.model_group)
                out[k] = torch.cat(parts, sharding[k])
            else:
                out[k] = gather_state(v, sharding, mesh)
        return out
    return state
