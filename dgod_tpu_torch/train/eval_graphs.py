"""The eval step's CUDA graphs: `train/steps.py::make_eval_step` serves the
model's `predict` as one graph replay per call instead of re-issuing its
~940 launches (DG Faster R-CNN at batch 1) through eager PyTorch.

Per input signature (the batch's keys, each tensor's shape, dtype and
device, any other value itself):
- the first call runs `predict` eagerly, which warms cuDNN and cuBLAS for
  those shapes;
- the second captures `predict` as a CUDA graph on a side stream and serves
  its request from the graph's first replay;
- every later call copies the batch into the graph's static inputs,
  replays the graph and returns copies of its static outputs, so what one
  call returned is not overwritten by the next.

At most MAX_GRAPHS signatures hold a graph. The others run eagerly, as do
a batch with a tensor off the card, a signature whose capture raised (a
`predict` that syncs with the host: FCOS's `normalize` makes its mean and
std on the host at every call) and a model whose layers `shard_model` split
(their forward runs collectives). A replay reads the model's parameters
and buffers where they lay at capture: the optimizer updates them in place,
so a replay computes with the newest weights. A graph that finds any of them
rebound (`load_state_dict(assign=True)`, a module moved) is dropped and
captured again.

Counters (module globals, as the kernels' launch counters are):
`graph_captures`, `graph_replays` (the capturing call's included) and
`graph_eager_calls` (every call served eagerly, fallbacks included). The
kernels' own counters stay true under replay: capture runs their Python
wrappers, which count launches that only a replay makes, so capture leaves
them as it found them and each replay adds what capture counted.
"""

from __future__ import annotations

import warnings
from typing import Dict

import torch

from ..ops import (cuda_attention, cuda_matchers, cuda_nms, cuda_proposals,
                   cuda_roi_align)
from ..parallel.tensor_parallel import holds_split_layers
from ..utils.logging import span

# the most input signatures one eval step holds a graph for
MAX_GRAPHS = 4

graph_captures = 0
graph_replays = 0
graph_eager_calls = 0

# the port's kernel launch counters: (module, name)
KERNEL_COUNTERS = ((cuda_roi_align, "fwd_launches"),
                   (cuda_roi_align, "bwd_launches"),
                   (cuda_matchers, "launches"),
                   (cuda_matchers, "fcos_launches"),
                   (cuda_proposals, "launches"),
                   (cuda_nms, "launches"),
                   (cuda_attention, "fwd_launches"),
                   (cuda_attention, "bwd_launches"))


def kernel_counts() -> tuple:
    return tuple(getattr(m, name) for m, name in KERNEL_COUNTERS)


def _add_counts(delta) -> None:
    for (m, name), d in zip(KERNEL_COUNTERS, delta):
        setattr(m, name, getattr(m, name) + d)


def signature(batch: Dict):
    """The batch's keys with each tensor's shape, dtype and device and any
    other value itself; None where a value cannot be hashed."""
    key = tuple((k, tuple(v.shape), v.dtype, v.device)
                if isinstance(v, torch.Tensor) else (k, v)
                for k, v in batch.items())
    try:
        hash(key)
    except TypeError:
        return None
    return key


def on_card(batch: Dict) -> bool:
    """Whether every tensor of the batch lies on one CUDA device."""
    devices = {v.device for v in batch.values()
               if isinstance(v, torch.Tensor)}
    return len(devices) == 1 and next(iter(devices)).type == "cuda"


class CudaGraph:
    """A torch.cuda.CUDAGraph captured on a side stream (`stream`)."""

    def __init__(self, stream):
        self.stream = stream
        self.graph = torch.cuda.CUDAGraph()

    @staticmethod
    def side_stream(device):
        return torch.cuda.Stream(device)

    def capture(self, fn, batch):
        """-> `fn(batch)`'s outputs, recorded (not run) into the graph."""
        # as torch.cuda.graph does: no work in flight while capture begins
        torch.cuda.synchronize(self.stream.device)
        with torch.cuda.stream(self.stream):
            # only this thread's unsafe calls invalidate the capture: the
            # loaders' threads go on with their own work
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(batch)
            finally:
                self.graph.capture_end()
        return out

    def replay(self) -> None:
        self.graph.replay()


class Replay:
    """One signature's graph: its static inputs and outputs (the predict's
    dict of tensors), the model's parameter and buffer tensors with their
    addresses at capture (held, so that no other tensor can take an address
    while the graph reads it), and the kernel launches one replay makes."""

    def __init__(self, model, batch: Dict, stream):
        self.inputs = {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in batch.items()}
        self.slots = [(m._parameters, n) for m in model.modules()
                      for n, p in m._parameters.items() if p is not None]
        self.slots += [(m._buffers, n) for m in model.modules()
                       for n, b in m._buffers.items() if b is not None]
        self.held = [d[n] for d, n in self.slots]
        self.addresses = [t.data_ptr() for t in self.held]
        self.graph = CudaGraph(stream)
        before = kernel_counts()
        try:
            self.outputs = self.graph.capture(model.predict, self.inputs)
        finally:
            self.launches = [a - b for a, b in zip(kernel_counts(), before)]
            _add_counts([-n for n in self.launches])

    def current(self) -> bool:
        """Whether every parameter and buffer still lies where it lay at
        capture."""
        try:
            return [d[n].data_ptr() for d, n in self.slots] == self.addresses
        except (KeyError, AttributeError):  # removed, or set to None
            return False

    def __call__(self, batch: Dict):
        global graph_replays
        with span("dgod.predict"):
            for k, v in self.inputs.items():
                if isinstance(v, torch.Tensor):
                    v.copy_(batch[k])
            self.graph.replay()
            _add_counts(self.launches)
            graph_replays += 1
            return {k: v.clone() for k, v in self.outputs.items()}


class EvalGraphs:
    """`model.predict(batch)`, served from a CUDA graph per input signature
    where one can be captured (see the module's docstring)."""

    def __init__(self, model):
        self.model = model
        self.seen = set()  # signatures called at least once
        self.eager = set()  # signatures that stay eager
        self.graphs = {}  # signature -> Replay
        self.streams = {}  # device -> the side stream of its captures

    def __call__(self, batch: Dict):
        global graph_eager_calls
        key = signature(batch)
        replay = self.graphs.get(key)
        if replay is not None and not replay.current():
            del self.graphs[key]
            replay = None
        if replay is None and self._may_capture(key, batch):
            replay = self._capture(key, batch)
        if replay is not None:
            return replay(batch)
        self.seen.add(key)
        graph_eager_calls += 1
        return self.model.predict(batch)

    def _may_capture(self, key, batch) -> bool:
        if key is None or key not in self.seen or key in self.eager \
                or len(self.graphs) >= MAX_GRAPHS or not on_card(batch):
            return False
        if holds_split_layers(self.model):
            self.eager.add(key)
            return False
        return True

    def _capture(self, key, batch):
        global graph_captures
        device = next(v.device for v in batch.values()
                      if isinstance(v, torch.Tensor))
        if device not in self.streams:
            self.streams[device] = CudaGraph.side_stream(device)
        try:
            replay = Replay(self.model, batch, self.streams[device])
        except RuntimeError as e:
            self.eager.add(key)
            warnings.warn(f"eval step: the predict could not be captured as "
                          f"a CUDA graph ({e}); batches of this signature "
                          f"run eagerly", RuntimeWarning, stacklevel=3)
            return None
        self.graphs[key] = replay
        graph_captures += 1
        return replay
