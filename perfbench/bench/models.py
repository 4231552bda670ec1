"""Both sides of a cell from one configuration file: the program's model
(dgod_tpu_torch, the system under test) and the plain reference's
(perfbench/reference), each built by the configuration's builder
(common.builder), with the weights that the benchmark makes from the seed
and hands to both.

The weights: every leaf that the model's initialisers name gets its scale
from them and its values from one truncated normal drawn on the card by a
seeded `torch.Generator` in one call; every other leaf keeps the value its
constructor gives (zero biases, unit GroupNorm scales, a head's class
prior). FrozenBatchNorm's statistics are those of each layer's own input on
the cell's images (calibrate_frozen_bn), taken through the reference in
float32: random convolutions under identity statistics let ResNet-50's
activations grow until the first SGD steps diverge, and no pretrained
statistics are on the machine."""

from __future__ import annotations

import contextlib

import torch

from . import common, synthetic

# the standard deviation of a unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def reference_model(config: dict, device, fp8: bool = False, dtype=None):
    """The reference's model of `config` on `device`, its parameters in
    float32 and its convolutions and box head computing in `dtype`, by
    default the precision the configuration states; its leaves as
    constructed (the initialisers draw nothing). `fp8`: the precision
    control, the nearest precision below, every Conv and Dense computing
    on fp8 operands."""
    return common.builder(config).reference_model(
        config, device, dtype or DTYPES[config["compute_dtype"]], fp8)


def program_model(config: dict, device):
    """The program's model of `config`, in the configuration's compute
    dtype, on `device`; its own initial draws are overwritten by
    `load_state`."""
    return common.builder(config).program_model(
        config, device, DTYPES[config["compute_dtype"]])


def frozen_bn_buffers(model) -> list:
    """Names of the FrozenBatchNorm statistics of `model`."""
    return [name for name, _ in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("scale", "bias", "mean", "var")]


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convolutions without TF32, for what the
    reference computes in float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def make_state(config: dict, seed: int, device, calibration_images):
    """The weights of `config` from `seed` and the FrozenBatchNorm
    statistics of `calibration_images` (uint8 NHWC on `device`): a dict
    name -> float32 tensor on `device`, for `load_state` into either side."""
    model = reference_model(config, device, dtype=torch.float32)
    names = {id(p): n for n, p in model.named_parameters()}
    spec = [(names[id(t)], t.shape, std) for t, std in model.init_spec]
    gen = torch.Generator(device=device).manual_seed(2 * seed)
    flat = torch.empty(sum(s.numel() for _, s, _ in spec), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    state, offset = {}, 0
    for name, shape, std in spec:
        n = shape.numel()
        state[name] = flat[offset:offset + n].view(shape) * (std / TRUNC_STD)
        offset += n
    for name, p in model.named_parameters():
        state.setdefault(name, p.detach().clone())
    buffers = dict(model.named_buffers())
    for name in frozen_bn_buffers(model):
        state[name] = buffers[name]
    load_state(model, state)
    with exact_float32():
        synthetic.calibrate_frozen_bn(model, calibration_images)
    for name in frozen_bn_buffers(model):
        state[name] = buffers[name].detach().clone()
    del model
    return state


@torch.no_grad()
def load_state(model, state: dict) -> None:
    """Copy `state` into `model`'s parameters and FrozenBatchNorm buffers;
    a leaf of either that the other lacks raises."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    want = set(params) | set(frozen_bn_buffers(model))
    if want != set(state):
        raise KeyError(f"the model's leaves and the state differ: "
                       f"{sorted(want ^ set(state))[:5]}")
    for name in want:
        (params[name] if name in params else buffers[name]).copy_(
            state[name])
