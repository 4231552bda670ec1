"""The builder of "family": "TINYVIT", a test's stand-in for a new
architecture: a tiny plain-ViT backbone (tinyvit_port.py on the program's
side, reference/models/tinyvit.py on the reference's) in place of DG Faster
R-CNN's ResNet-50 FPN, with the RPN, the RoI heads and the DG heads as they
are. It takes the FRCNN builder's draws and kernels, and adds K9, the
attention's kernel."""

from perfbench.bench import build, common, flops_tinyvit

FRCNN = common.builder({"family": "FRCNN"})


def _frcnn(config: dict) -> dict:
    """The configuration as the FRCNN builder reads it: the ResNet that the
    backbone replaces is built at its least."""
    return dict(config, backbone_block_counts=[1, 1, 1, 1])


def program_model(config: dict, device, compute_dtype):
    import tinyvit_port

    model = FRCNN.program_model(_frcnn(config), device, compute_dtype)
    model.detector.backbone = tinyvit_port.Backbone(
        dtype=compute_dtype, **config["vit"]).to(device)
    return model


def reference_model(config: dict, device, compute_dtype, fp8: bool):
    from perfbench.reference.models import layers, tinyvit

    model = FRCNN.reference_model(_frcnn(config), device, compute_dtype,
                                  False)
    backbone = tinyvit.Backbone(dtype=compute_dtype, **config["vit"])
    model.detector.backbone = backbone.to(device)
    spec = []
    backbone.reset_parameters(spec)
    held = {id(p) for p in model.parameters()}
    model.init_spec = spec + [(t, s) for t, s in model.init_spec
                              if id(t) in held]
    if fp8:
        build.fp8_control(model, (layers.Conv, layers.Dense))
    return model


draw_maker = FRCNN.draw_maker
wrap_draws = FRCNN.wrap_draws
train_flops_per_image = flops_tinyvit.train_flops_per_image
predict_flops_per_image = flops_tinyvit.predict_flops_per_image


def kernels_on(path: str, config: dict) -> dict:
    h, w = flops_tinyvit.tokens(config)
    return dict(FRCNN.kernels_on(path, config),
                K9={"tokens": h * w, "dim": config["vit"]["dim"]})


def tiny(config: dict) -> None:
    FRCNN.tiny(config)
