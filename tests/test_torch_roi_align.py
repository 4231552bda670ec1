"""Port parity: multi-scale RoIAlign (the plain version of kernels K1/K2).

dgod_tpu_torch.ops.roi_align.roi_align_plain against dgod_tpu's XLA path
(ops/roi_align.py) and against the Pallas kernel in interpret mode
(ops/pallas_roi_align.py), forward at rtol 1e-5 and backward (autograd vs
jax.vjp) at rtol 1e-4, on RoIs that hit every level, slivers spanning many
cells, degenerate and out-of-image boxes. On the CPU, the model's entry
point `roi_align` is the plain version.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgod_tpu.ops.pallas_roi_align import batched_roi_align_tpu
from dgod_tpu.ops.roi_align import multiscale_roi_align
from dgod_tpu_torch.ops import roi_align as T

STRIDES = (4, 8, 16, 32)
CANVAS = (128, 256)


def _feats(rng, B, C):
    return [rng.randn(B, CANVAS[0] // s, CANVAS[1] // s, C).astype(np.float32)
            for s in STRIDES]


def _rois(rng, B, N):
    rois = np.zeros((B, N, 4), np.float32)
    specials = [
        [0, 0, 0, 0],             # degenerate
        [0, 0, 255, 3],           # wide sliver
        [5, 0, 8, 127],           # tall sliver
        [-10, -10, 300, 300],     # exceeds the image, coarsest level
        [250, 120, 258, 130],     # touches the border
        [-40, -30, -2, -1],       # wholly outside
        [30.5, 20.25, 31.0, 20.5],  # sub-cell
    ]
    for b in range(B):
        for i in range(N):
            if i < len(specials):
                rois[b, i] = specials[i]
            else:
                x1, y1 = rng.uniform(0, 200), rng.uniform(0, 100)
                w, h = rng.uniform(2, 250), rng.uniform(2, 120)
                rois[b, i] = [x1, y1, x1 + w, y1 + h]
    return rois


def _xla(feats, rois):
    return jax.vmap(lambda f0, f1, f2, f3, r: multiscale_roi_align(
        [f0, f1, f2, f3], r, STRIDES))(*feats, rois)


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def test_level_assignment_matches_jax_formula():
    rng = np.random.RandomState(0)
    side = np.exp(rng.uniform(np.log(0.5), np.log(2000), (500, 2)))
    x1 = rng.uniform(-50, 500, (500, 2))
    rois = np.concatenate([x1, x1 + side], 1).astype(np.float32)
    # boxes at exactly the canonical scale boundaries
    rois[:4] = [[0, 0, 112, 112], [0, 0, 224, 224], [0, 0, 448, 448],
                [0, 0, 56, 56]]
    r = jnp.asarray(rois)
    area = jnp.clip((r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1]), 0.0)
    k = jnp.floor(4 + jnp.log2(jnp.sqrt(area) / 224.0 + 1e-6))
    ref = np.asarray(jnp.clip(k - 2, 0, 3).astype(jnp.int32))
    got = T.level_assignment(torch.from_numpy(rois)).numpy()
    np.testing.assert_array_equal(ref, got)
    assert set(got) == {0, 1, 2, 3}


@pytest.mark.parametrize("B,N,C", [(2, 16, 32), (1, 40, 8)])
def test_forward_matches_xla_and_pallas(B, N, C):
    rng = np.random.RandomState(B * 100 + N)
    feats = _feats(rng, B, C)
    rois = _rois(rng, B, N)
    got = T.roi_align_plain(_t(feats), torch.from_numpy(rois)).numpy()
    assert got.shape == (B, N, 7, 7, C) and got.dtype == np.float32
    ref = np.asarray(_xla([jnp.asarray(f) for f in feats], jnp.asarray(rois)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # the Pallas kernel contracts its separable weights as matmuls, so it
    # sits up to ~1e-5 from the XLA path itself (its own tests allow 1e-3):
    # the port must be no further from it than the XLA path is, beyond the
    # rtol 1e-5 that separates the port from the XLA path
    pallas = np.asarray(batched_roi_align_tpu(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), STRIDES,
        True))
    bound = np.abs(ref - pallas) + 1e-5 * np.abs(ref) + 1e-6
    assert (np.abs(got - pallas) <= bound).all()


def test_backward_matches_jax_vjp_and_pallas():
    rng = np.random.RandomState(1)
    B, N, C = 2, 14, 16
    feats = _feats(rng, B, C)
    rois = _rois(rng, B, N)
    g = rng.randn(B, N, 7, 7, C).astype(np.float32)

    leaves = [f.requires_grad_(True) for f in _t(feats)]
    out = T.roi_align_plain(leaves, torch.from_numpy(rois))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))

    jf = tuple(jnp.asarray(f) for f in feats)
    _, vjp = jax.vjp(lambda fs: _xla(fs, jnp.asarray(rois)), jf)
    (ref,) = vjp(jnp.asarray(g))
    _, vjp_p = jax.vjp(lambda fs: batched_roi_align_tpu(
        fs, jnp.asarray(rois), STRIDES, True), jf)
    (ref_p,) = vjp_p(jnp.asarray(g))
    for lvl in range(4):
        a = got[lvl].numpy()
        np.testing.assert_allclose(a, np.asarray(ref[lvl]), rtol=1e-4,
                                   atol=1e-5, err_msg=f"P{lvl + 2}")
        np.testing.assert_allclose(a, np.asarray(ref_p[lvl]), rtol=1e-4,
                                   atol=1e-4, err_msg=f"P{lvl + 2} pallas")


def test_bfloat16_features_match_xla():
    """bf16 levels: both gather bf16 cells and interpolate in float32."""
    rng = np.random.RandomState(2)
    feats = _feats(rng, 1, 16)
    rois = _rois(rng, 1, 12)
    tf = [f.to(torch.bfloat16) for f in _t(feats)]
    got = T.roi_align_plain(tf, torch.from_numpy(rois))
    assert got.dtype == torch.float32
    ref = _xla([jnp.asarray(f, jnp.bfloat16) for f in feats],
               jnp.asarray(rois))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_entry_point_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(3)
    feats = _t(_feats(rng, 2, 8))
    rois = torch.from_numpy(_rois(rng, 2, 9))
    assert torch.equal(T.roi_align(feats, rois), T.roi_align_plain(feats, rois))


def test_grad_flows_only_to_touched_cells():
    """A single small RoI leaves grads only at its own level and cells."""
    rng = np.random.RandomState(4)
    leaves = [f.requires_grad_(True) for f in _t(_feats(rng, 1, 8))]
    rois = torch.tensor([[[40.0, 40.0, 80.0, 80.0]]])  # P2 (sqrt area 40)
    out = T.roi_align(leaves, rois)
    d = torch.autograd.grad(out, leaves, torch.ones_like(out))
    assert float(d[0].abs().sum()) > 0
    for lvl in (1, 2, 3):
        assert float(d[lvl].abs().sum()) == 0.0
    nz = np.argwhere(d[0][0].abs().sum(-1).numpy() > 0)
    assert nz[:, 0].min() >= 9 and nz[:, 0].max() <= 21
    assert nz[:, 1].min() >= 9 and nz[:, 1].max() <= 21


# -- K2's tiled gather (csrc/roi_align.cu), modelled on the CPU ---------------
#
# The kernel's geometry pass marks, per RoI and axis, the 8-cell tiles that a
# sample corner of non-zero weight touches (one bit per tile, or per run of
# tiles past 64 tiles); its gather gives each tile the RoIs whose two masks
# hit it, in ascending order. A bin's gradient is shared by its 2x2 samples,
# so per bin row (column) the kernel merges its two samples' corners inside
# the tile into at most 4 (cell, summed weight) entries and adds
# g/4 * wy * wx to every (row entry, column entry) cell. The model below
# follows those steps on the plain version's sample geometry.

K2_TILE = 8
K2_MASK_BITS = 64
FULL_CANVAS = (608, 1216)


def _k2_geometry(rois, shapes):
    """rois [n,4] -> (level [n], per axis (y, x): lo, hi, w_lo, w_hi
    [n,14], out-of-range samples weighted 0), as roi_align_plain samples."""
    rois = torch.from_numpy(rois)
    lvl = T.level_assignment(rois)
    scale = torch.tensor([1.0 / s for s in STRIDES])[lvl]
    sizes = torch.tensor(shapes)[lvl]  # [n, 2] (h, w)
    ar = torch.arange(14, dtype=torch.float32)
    steps = torch.div(ar, 2, rounding_mode="floor") + (ar % 2 + 0.5) / 2
    axes = []
    for axis, (a, b) in enumerate(((1, 3), (0, 2))):
        c1, c2 = rois[:, a] * scale, rois[:, b] * scale
        step = torch.clamp(c2 - c1, min=1.0) / T._const(7, c1)
        coord = c1[:, None] + steps[None] * step[:, None]
        lo, hi, wlo, whi, ok = T._bilinear_params(coord,
                                                  sizes[:, axis:axis + 1])
        axes.append(tuple(x.numpy() for x in (lo, hi, wlo * ok, whi * ok)))
    return lvl.numpy(), axes


def _k2_per(size):
    """Tiles per mask bit along an axis of `size` cells."""
    tiles = -(-size // K2_TILE)
    return -(-tiles // K2_MASK_BITS)


def _k2_masks(lvl, axes, shapes):
    """Per RoI, (rows, cols): the tile-mask bits the geometry pass sets."""
    masks = []
    for r, l in enumerate(lvl):
        pair = []
        for axis, (lo, hi, wlo, whi) in enumerate(axes):
            per = _k2_per(shapes[l][axis])
            bits = 0
            for c, w in ((lo[r], wlo[r]), (hi[r], whi[r])):
                for cell in c[w != 0]:
                    bits |= 1 << (int(cell) // K2_TILE // per)
            pair.append(bits)
        masks.append(pair)
    return masks


def _k2_hits(mask_pair, l, lvl_r, ty, tx, shapes):
    h, w = shapes[l]
    return (lvl_r == l and (mask_pair[0] >> (ty // _k2_per(h))) & 1
            and (mask_pair[1] >> (tx // _k2_per(w))) & 1)


def _k2_entries(axis, r, p, origin):
    """Bin row (axis 0) or column (axis 1) p of RoI r in a tile starting at
    cell `origin`: its two samples' corners of non-zero weight inside the
    tile, equal cells merged, weights summed in the kernel's order (sample
    0 lo, hi, sample 1 lo, hi)."""
    lo, hi, wlo, whi = axis
    cells, ws = [], []
    for i in (2 * p, 2 * p + 1):
        for c, w in ((lo[r, i], wlo[r, i]), (hi[r, i], whi[r, i])):
            cell = int(c) - origin
            if w == 0 or not 0 <= cell < K2_TILE:
                continue
            if cell in cells:
                ws[cells.index(cell)] += w
            else:
                cells.append(cell)
                ws.append(np.float32(w))
    assert len(cells) <= 4
    return list(zip(cells, ws))


def _k2_gather(lvl, axes, masks, g, shapes):
    """g [n,7,7,C] -> per-level grads [H,W,C], one tile at a time."""
    out = [np.zeros((h, w, g.shape[-1]), np.float32) for h, w in shapes]
    for l, (h, w) in enumerate(shapes):
        for ty in range(-(-h // K2_TILE)):
            for tx in range(-(-w // K2_TILE)):
                acc = out[l][ty * K2_TILE:(ty + 1) * K2_TILE,
                             tx * K2_TILE:(tx + 1) * K2_TILE]
                for r in range(len(lvl)):
                    if not _k2_hits(masks[r], l, lvl[r], ty, tx, shapes):
                        continue
                    rows = [_k2_entries(axes[0], r, p, ty * K2_TILE)
                            for p in range(7)]
                    cols = [_k2_entries(axes[1], r, p, tx * K2_TILE)
                            for p in range(7)]
                    for py in range(7):
                        for px in range(7):
                            gq = g[r, py, px] * np.float32(0.25)
                            for y, wy in rows[py]:
                                wg = wy * gq
                                for x, wx in cols[px]:
                                    acc[y, x] += wg * wx
    return out


def _k2_rois(canvas):
    """The adversarial RoIs of chip_smoke.py at `canvas` (slivers across
    the level, out-of-canvas, corner-straddling, degenerate, sub-pixel)
    and a few ordinary ones."""
    H, W = canvas
    rng = np.random.RandomState(H + W)
    ordinary = []
    for _ in range(6):
        x, y = rng.uniform(-20, W - 20), rng.uniform(-20, H - 20)
        ordinary.append([x, y, x + rng.uniform(4, W / 2),
                         y + rng.uniform(4, H / 2)])
    return np.array([
        [0, 0, 0, 0], [10, 100 % H, W - 10, 100 % H + 2],
        [W / 2, 0, W / 2 + 1.5, H], [-300, -200, W + 300, H + 200],
        [W + 20, H + 20, W + 80, H + 90], [-90, -60, -10, -5],
        [W - 8, H - 8, W + 8, H + 8], [0.5, 0.5, 1.0, 1.0],
        [0, H / 2, 1200, H / 2 + 2],  # a 1200x2 sliver on P2
    ] + ordinary, np.float32)


# the full canvas, the tests' canvas, and one whose P2 has 100 tiles along x
# (two tiles per mask bit)
K2_CANVASES = [FULL_CANVAS, CANVAS, (64, 3200)]


def _k2_shapes(canvas):
    return [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in STRIDES]


def _k2_autograd(shapes, rois, g):
    leaves = [torch.zeros(1, h, w, g.shape[-1], requires_grad=True)
              for h, w in shapes]
    out = T.roi_align_plain(leaves, torch.from_numpy(rois)[None])
    return [d[0].numpy() for d in torch.autograd.grad(
        out, leaves, torch.from_numpy(g)[None])]


@pytest.mark.parametrize("canvas", K2_CANVASES)
def test_k2_tile_masks_cover_every_touched_cell(canvas):
    """Each RoI alone: every cell where autograd of the plain version is
    non-zero lies at the RoI's level, in a tile both its masks hit."""
    shapes = _k2_shapes(canvas)
    rois = _k2_rois(canvas)
    lvl, axes = _k2_geometry(rois, shapes)
    masks = _k2_masks(lvl, axes, shapes)
    g = (np.abs(np.random.RandomState(5).randn(len(rois), 7, 7, 1))
         + 0.5).astype(np.float32)  # positive: no sum cancels to 0
    touched = 0
    for r in range(len(rois)):
        grads = _k2_autograd(shapes, rois[r:r + 1], g[r:r + 1])
        for l, d in enumerate(grads):
            cells = np.argwhere(np.abs(d).sum(-1) > 0)
            assert l == lvl[r] or not len(cells), (r, l)
            for y, x in cells:
                assert _k2_hits(masks[r], l, lvl[r], y // K2_TILE,
                                x // K2_TILE, shapes), (r, l, y, x)
            touched += len(cells)
    assert touched > 0
    if canvas == (64, 3200):
        assert _k2_per(shapes[0][1]) == 2


@pytest.mark.parametrize("canvas", K2_CANVASES)
def test_k2_tiled_gather_model_matches_autograd(canvas):
    shapes = _k2_shapes(canvas)
    rois = _k2_rois(canvas)
    lvl, axes = _k2_geometry(rois, shapes)
    masks = _k2_masks(lvl, axes, shapes)
    g = np.random.RandomState(6).randn(len(rois), 7, 7, 3).astype(np.float32)
    got = _k2_gather(lvl, axes, masks, g, shapes)
    for l, ref in enumerate(_k2_autograd(shapes, rois, g)):
        assert got[l].shape == ref.shape
        np.testing.assert_allclose(got[l], ref, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(ref).max()),
                                   err_msg=f"P{l + 2}")


# -- K1's per-bin sum (csrc/roi_align.cu), modelled on the CPU -----------------
#
# A warp of the kernel pools one bin row; per bin it loads its 16 corners
# and sums them in one fixed order: samples (sy, sx)
# row-major, per sample the corners (y lo, x lo), (y lo, x hi), (y hi, x lo),
# (y hi, x hi), each added to an f32 sum that starts at 0 as one fused
# multiply-add of its rounded weight wy*wx; the sum is then scaled by 1/4.
# The model follows that order on the plain version's sample geometry (the
# fused multiply-add as an exact product and sum in float64, rounded once).

def _k1_model(feats, rois):
    """feats per level [B,H,W,C] float32 numpy, rois [B,N,4] -> pooled
    [B,N,7,7,C] in the kernel's summation order."""
    B, N = rois.shape[:2]
    C = feats[0].shape[-1]
    shapes = [f.shape[1:3] for f in feats]
    out = np.zeros((B, N, 7, 7, C), np.float32)
    for b in range(B):
        lvl, (y_axis, x_axis) = _k2_geometry(rois[b], shapes)
        for r in range(N):
            f = feats[lvl[r]][b].astype(np.float64)
            for py in range(7):
                for px in range(7):
                    acc = np.zeros(C, np.float32)
                    for sy in range(2):
                        for sx in range(2):
                            iy, ix = 2 * py + sy, 2 * px + sx
                            for row, wy in ((y_axis[0][r, iy], y_axis[2][r, iy]),
                                            (y_axis[1][r, iy], y_axis[3][r, iy])):
                                for col, wx in ((x_axis[0][r, ix], x_axis[2][r, ix]),
                                                (x_axis[1][r, ix], x_axis[3][r, ix])):
                                    w = np.float32(wy * wx)
                                    acc = (np.float64(w) * f[row, col]
                                           + acc).astype(np.float32)
                    out[b, r, py, px] = acc * np.float32(0.25)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_bin_sum_order_model_matches_plain(dtype):
    rng = np.random.RandomState(7)
    feats = [torch.from_numpy(f).to(dtype) for f in _feats(rng, 2, 16)]
    rois = _rois(rng, 2, 16)
    ref = T.roi_align_plain(feats, torch.from_numpy(rois)).numpy()
    got = _k1_model([f.float().numpy() for f in feats], rois)
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.abs(ref).max() > 0
