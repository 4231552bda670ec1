"""Process-group wiring and per-node data sharding (port of
dgod_tpu/parallel/multihost.py over `torch.distributed`).

One process drives one card, as `torchrun` launches them. A torch rank
stands where the JAX package has a device, and a torch node (the ranks of
one host, `LOCAL_WORLD_SIZE` of them) where it has a process/host, so:

- `initialize()` joins the process group, deciding from the environment
  and its arguments alone, before anything touches CUDA;
- `host_shard_range(n)` gives this node's contiguous slice of a dataset,
  so each node's input pipeline loads only its share;
- `all_gather_host_arrays(tree)` gathers small numpy trees (the per-image
  detections of a validation sweep) onto every rank.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

# torchrun's environment: a launcher that sets these has made the group
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE")


def _slurm_nodes() -> int:
    try:
        return int(os.environ.get("SLURM_JOB_NUM_NODES", "1"))
    except ValueError:
        return 1


def _in_cluster_env(coordinator_address, num_processes) -> bool:
    # explicit arguments count as a cluster signal (a caller passing
    # num_processes/process_id without an address takes the coordinator
    # from MASTER_ADDR/MASTER_PORT but still means "multi-process")
    if coordinator_address or num_processes:
        return True
    if all(os.environ.get(v) for v in _TORCHRUN_ENV):
        return True
    # SLURM sets SLURM_JOB_NUM_NODES=1 on every job, single-node
    # interactive shells included: only a multi-node value is a cluster
    return _slurm_nodes() > 1


def _slurm_env() -> None:
    """torchrun's variables from a multi-node SLURM step's (one task per
    card). The coordinator's address is not derived: SLURM's node list is
    compressed, so MASTER_ADDR and MASTER_PORT must be set by the job."""
    for var, slurm in (("RANK", "SLURM_PROCID"), ("WORLD_SIZE", "SLURM_NTASKS"),
                       ("LOCAL_RANK", "SLURM_LOCALID")):
        if var not in os.environ and slurm in os.environ:
            os.environ[var] = os.environ[slurm]
    if "LOCAL_WORLD_SIZE" not in os.environ and "SLURM_NTASKS" in os.environ:
        os.environ["LOCAL_WORLD_SIZE"] = str(
            int(os.environ["SLURM_NTASKS"]) // _slurm_nodes())
    if not (os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT")):
        raise RuntimeError(
            "a multi-node SLURM job must set MASTER_ADDR and MASTER_PORT "
            "(the address of the node that runs rank 0, and a free port)")


def _init_method(coordinator_address) -> str:
    if not coordinator_address:
        return "env://"
    if "://" in coordinator_address:  # tcp://host:port, file:///path
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device=None, timeout=DEFAULT_TIMEOUT):
    """Idempotent process-group init.

    The decision comes from the arguments and the environment alone
    (torchrun's RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT, or a multi-node
    SLURM job); without any cluster signal this is a one-process run and
    nothing is wired. The backend is NCCL on the card (`device=None` means
    the card, as everywhere in the port) and gloo on the CPU (tests only);
    there is no fallback from one to the other. On the card this rank's
    device (`LOCAL_RANK`) is made current before the group is made.
    Failures propagate, and every collective times out after `timeout`."""
    if dist.is_initialized():
        return  # already initialised (idempotent re-entry)
    if not _in_cluster_env(coordinator_address, num_processes):
        return  # one process: nothing to wire
    if not (coordinator_address or num_processes) and _slurm_nodes() > 1:
        _slurm_env()
    dev = resolve_device(device)  # sets the card of LOCAL_RANK current
    kw = {}
    if num_processes:
        kw.update(world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=_init_method(coordinator_address),
                            timeout=timeout, **kw)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size(world=None) -> int:
    """Ranks per node: torchrun's LOCAL_WORLD_SIZE, else one node of
    `world` (default: the group's) ranks."""
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              world_size() if world is None else world))


def node_index() -> int:
    return rank() // local_world_size()


def node_count() -> int:
    return world_size() // local_world_size()


def host_shard_range(n_examples: int, even: bool = False):
    """This node's [start, stop) slice of a dataset of n_examples.

    `even=True` gives every node an identical floor(n/k)-sized slice,
    dropping up to k-1 tail examples: a hard requirement for TRAIN
    sharding, where unequal per-node batch counts would leave the ranks of
    one node waiting in a collective the others never issue. Eval keeps
    the ceil split (no example dropped) and equalises batch counts with
    EvalLoader(pad_to_batches=...) dummy batches instead."""
    p, k = node_index(), node_count()
    if even:
        per = n_examples // k
        return p * per, (p + 1) * per
    per = (n_examples + k - 1) // k
    return min(n_examples, p * per), min(n_examples, (p + 1) * per)


def all_gather_host_arrays(tree):
    """Gather a numpy tree (dicts, lists, tuples of arrays) from every
    rank onto every rank: each leaf comes back stacked over the ranks
    ([world, ...]; the leaves must have the same shape on every rank). With
    one rank (or no group) the tree itself comes back, as JAX's
    process_allgather does on one process."""
    if world_size() == 1:
        return tree
    got = [None] * world_size()
    dist.all_gather_object(got, tree)

    def stack(parts):
        first = parts[0]
        if isinstance(first, dict):
            return {k: stack([p[k] for p in parts]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(stack([p[i] for p in parts])
                               for i in range(len(first)))
        return np.stack([np.asarray(p) for p in parts])

    return stack(got)


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s picklable `obj` (tensors on the CPU) on every rank;
    `obj` itself without a group."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` from rank `src` to all
    ranks (no-op without a group)."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in module.state_dict().values():
            dist.broadcast(t, src)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
