"""The ViTDet-B cell's own files: the FLOP count's attention and the K7/K8
work in the units bench/kernels.py::bound_s divides by, so that their
share reads against the dense bf16 peak and cannot pass 100%."""

import pytest

from perfbench.bench import common, flops_vitdet, kernels


def _config():
    return common.load_cell("vitdet-dg_train")["config"]


def test_perfbench_vitdet_attention_shapes_and_flops():
    c = _config()
    shapes = flops_vitdet.attention_shapes(c)
    assert shapes["window"] == {"blocks": 8, "per_image": 18,
                                "grid": [14, 14]}
    assert shapes["global"] == {"blocks": 4, "per_image": 1,
                                "grid": [38, 76]}
    a = flops_vitdet.attention_flops(shapes["global"], 12, 64)
    assert a["products"] == 2 * 2.0 * 2888 ** 2 * 768
    # the forward of one image: the ViT and pyramid, ~742 GFLOP; a trained
    # image of the DG cycle costs about three FRCNN images
    assert flops_vitdet.backbone_flops(c) == pytest.approx(741.94e9,
                                                           rel=1e-4)
    frcnn = common.load_cell("frcnn-dg_train")["config"]
    ratio = (flops_vitdet.train_flops_per_image(c, 8)
             / common.builder(frcnn).train_flops_per_image(frcnn, 8))
    assert 2.9 < ratio < 3.1


@pytest.mark.parametrize("kid,products", [("K7", 2), ("K8", 5)])
def test_perfbench_vitdet_kernel_bounds_at_the_bf16_peak(kid, products):
    """A launch's bound is its products' time at the bf16 peak (the
    float32 work on the logits is smaller), the mean over the 8 window and
    4 global blocks of a forward or backward."""
    c = _config()
    nbytes, ops = kernels.launch_work(kid, "train", c, 8, 128)
    mma = 0.0
    for n_att, n, blocks in ((8 * 18 * 12, 196, 8), (8 * 12, 2888, 4)):
        mma += blocks * n_att * products * 2.0 * n * n * 64
    bf16_s = mma / 12 / kernels.BF16_PEAK_FLOPS
    assert ops / kernels.F32_FLOPS == pytest.approx(bf16_s, rel=1e-12)
    assert kernels.bound_s(kid, "train", c, 8, 128) == pytest.approx(
        max(bf16_s, nbytes / kernels.HBM_BYTES_PER_S), rel=1e-12)
    assert set(common.builder(c).kernels_on("predict", c)) == {
        "K1", "K2", "K3", "K5", "K6", "K7"}


def test_perfbench_vitdet_reference_follows_the_programs_proposals():
    """The builder records the proposals of the program's first TAPED
    training forwards, then gives the detector back its own method; each
    reference model built after takes them in order, cut to a forward's
    images, and computes its own for a forward of more images than its
    entry and for every forward past the tape."""
    import torch

    from perfbench.bench import models
    from perfbench.tests.tiny import tiny_cell

    c = tiny_cell("vitdet-dg_train")["config"]
    builder = common.builder(c)
    cpu = torch.device("cpu")
    det = models.program_model(c, cpu).detector

    def inputs(images, seed):
        gen = torch.Generator().manual_seed(seed)
        obj = [torch.randn((images, n), generator=gen)
               for n in det.anchor_counts]
        deltas = [0.1 * torch.randn((images, n, 4), generator=gen)
                  for n in det.anchor_counts]
        sizes = torch.tensor([c["canvas"]] * images, dtype=torch.float32)
        return obj, deltas, sizes

    det.generate_proposals(*inputs(2, 50), training=False)  # not recorded
    taped = [det.generate_proposals(*inputs(2, i), training=True)
             for i in range(builder.TAPED)]
    assert "generate_proposals" not in vars(det)
    assert len(builder._tape) == builder.TAPED

    ref = models.reference_model(c, cpu).detector
    own = type(ref).generate_proposals
    for i, (boxes, valid, _) in enumerate(taped):
        images = 1 if i == 1 else 2
        got = ref.generate_proposals(*inputs(images, 100 + i), training=True)
        assert torch.equal(got[0], boxes[:images])
        assert torch.equal(got[1], valid[:images])
    for images in (2, 3):
        x = inputs(images, 7)
        got = ref.generate_proposals(*x, training=True)
        want = own(ref, *x, training=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    ref = models.reference_model(c, cpu).detector
    x = inputs(3, 8)  # more images than the entry holds: its own
    got = ref.generate_proposals(*x, training=True)
    assert torch.equal(got[0], own(ref, *x, training=True)[0])
