"""The ('data', 'model') mesh of ranks and its sharding rules (port of
dgod_tpu/parallel/mesh.py).

- The ranks are laid out as `rank = d * model + m`, the order of JAX's
  `reshape(data, model)` over its devices. The batch is split over 'data';
  the ranks of one data coordinate hold the same rows, and split the wide
  head layers (`TP_PATTERNS`) over 'model' (tensor parallelism,
  tensor_parallel.py). Pipeline, sequence and expert parallelism do not
  apply to a ~40M-parameter CNN detector, as in the JAX package.
- Unlike a JAX mesh, which may leave devices idle, the mesh must hold every
  rank: an idle rank would wait forever in the first collective of the
  others, so a spec that leaves ranks out raises.
- A host batch (`--batch_size` rows, loaded by each node) is split into
  row blocks over the node's data coordinates (`Mesh.row_block`), as the
  JAX placer splits a host batch over its local devices.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import multihost

# parameter-name substrings whose Dense/Conv layers are split over 'model'
TP_PATTERNS = ("box_head", "fc6", "fc7", "cls_conv", "reg_conv")


class Mesh:
    """This rank's place in a data x model mesh of all the ranks, with its
    data group (the ranks of its model coordinate: gradients are reduced
    over it) and model group (the ranks of its data coordinate: the split
    layers gather over it). Without a process group (one process) both
    groups are None and collectives are skipped."""

    def __init__(self, data: int, model: int = 1):
        self.data, self.model = int(data), int(model)
        self.d, self.m = divmod(multihost.rank(), self.model)
        self.data_group = self.model_group = None
        if dist.is_initialized():
            # every rank makes every group, in the same order
            for m in range(self.model):
                g = dist.new_group([d * self.model + m
                                    for d in range(self.data)])
                if m == self.m:
                    self.data_group = g
            for d in range(self.data):
                g = dist.new_group([d * self.model + m
                                    for m in range(self.model)])
                if d == self.d:
                    self.model_group = g
        local = multihost.local_world_size(self.data * self.model)
        if local % self.model:
            raise ValueError(
                f"model axis {self.model} does not divide the {local} ranks "
                "of a node: a model group must lie within one node")
        # the data coordinates of one node share its host batch
        self.local_data = local // self.model
        self.local_d = self.d % self.local_data

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def row_block(self, n: int):
        """This rank's [start, stop) rows of a host batch of `n` rows."""
        if n % self.local_data:
            raise ValueError(
                f"batch dim {n} not divisible by the {self.local_data} data "
                "coordinates of a node; choose a batch size divisible by "
                "them")
        per = n // self.local_data
        return self.local_d * per, (self.local_d + 1) * per

    def __repr__(self):
        return (f"Mesh(data={self.data}, model={self.model}, d={self.d}, "
                f"m={self.m})")


def make_mesh(world: Optional[int] = None, data: int = None,
              model: int = 1) -> Mesh:
    world = multihost.world_size() if world is None else world
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {world}")
    return Mesh(data, model)


def parse_mesh_spec(spec: str, world: Optional[int] = None) -> Mesh:
    """CLI `--mesh` spec -> Mesh over all the ranks.

    Forms: 'auto' (all ranks, pure data parallelism), 'data=N',
    'data=N,model=M', 'model=M' (data inferred as world/M)."""
    world = multihost.world_size() if world is None else world
    spec = spec.strip().lower()
    if spec in ("auto", "all", ""):
        return make_mesh(world)
    data = model = None
    for part in spec.split(","):
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in ("data", "model") or not val.strip().isdigit():
            raise ValueError(
                f"bad --mesh spec {spec!r}: expected 'auto' or "
                "'data=N[,model=M]'")
        if key == "data":
            data = int(val)
        else:
            model = int(val)
    model = model or 1
    if data is None:
        data = world // model
    need = data * model
    if need > world:
        raise ValueError(f"--mesh {spec!r} needs {need} devices, have {world}")
    if need < world:
        raise ValueError(
            f"--mesh {spec!r} uses {need} of {world} ranks: every rank must "
            "hold a place in the mesh (an idle rank would wait forever in "
            "the others' first collective)")
    return make_mesh(world, data, model)


def param_sharding(model: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """{parameter name: the dim split over 'model'} for the parameters
    that tensor parallelism splits; every other parameter is replicated.
    The split dim is 0 of the port's [out, in] Dense and OIHW Conv weights
    and of their biases, the JAX kernels' last axis, and it must divide by
    the model axis (JAX's rule)."""
    if mesh.model == 1:
        return {}
    return {name: 0 for name, p in model.named_parameters()
            if any(pat in name for pat in TP_PATTERNS)
            and p.dim() >= 1 and p.shape[0] % mesh.model == 0}


def batch_rows(batch: dict, mesh: Mesh) -> dict:
    """This rank's row block of a host batch (arrays or tensors with a
    leading batch dim); an eval tail's `num_real` becomes the block's
    count of real rows. Raises ValueError when the rows do not divide."""
    n = next(len(v) for v in batch.values()
             if isinstance(v, (np.ndarray, torch.Tensor)))
    start, stop = mesh.row_block(n)
    out = {k: v[start:stop] if isinstance(v, (np.ndarray, torch.Tensor))
           else v for k, v in batch.items()}
    if "num_real" in batch:
        out["num_real"] = int(np.clip(batch["num_real"] - start, 0,
                                      stop - start))
    return out
