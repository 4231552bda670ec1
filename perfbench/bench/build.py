"""What every architecture shares: the optimizer's configuration from a
configuration file's `optimizer` object and the first update as each kind
of optimizer takes it (both read by train.TrainSide), and the precision
control's switch on the reference's layers (read by the builders under
perfbench/builders)."""

from __future__ import annotations


def opt_config(optim, config: dict):
    """`optim.OptConfig` (the program's or the reference's) from the
    configuration's whole `optimizer` object but its `lr`, which the pair
    steps take apart: a setting the class does not know raises."""
    return optim.OptConfig(**{k: v for k, v in config["optimizer"].items()
                              if k != "lr"})


def first_update(side, init: dict) -> dict:
    """Per leaf, the first update as the optimizer of `side`
    (train.TrainSide) took it; `init`: the parameters before it. SGD: the
    change over the learning rate; any other kind (Adam's family): the
    first moment over 1 - b1."""
    if side.opt_config.kind == "sgd":
        params = dict(side.model.named_parameters())
        return {n: (init[n] - p.detach()) / side.lr
                for n, p in params.items()}
    b1 = side.opt_config.b1
    return {n: m / (1 - b1) for n, m in side.opt_state["mu"].items()}


def fp8_control(model, layer_types) -> None:
    """Every module of `model` of `layer_types` computes on fp8 operands
    (the reference's `fp8` switch)."""
    for m in model.modules():
        if isinstance(m, layer_types):
            m.fp8 = True
