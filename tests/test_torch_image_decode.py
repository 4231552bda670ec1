"""The port's image decode without cv2 (csrc/host/image_decode.cpp through
data/png.py, data/jpeg.py) against OpenCV, which the JAX package reads
images with:

- the C++ PNG unfilter equals the Python unfilter (`decode_png_plain`) and
  `cv2.imread` on PNGs whose rows use each of the five filters, RGB and
  RGBA, at sizes from one pixel up (hypothesis), PNGs made by
  the filtering encoder chip_smoke.py and the e2e bench write with
  (`utils/synthetic.png_filtered`);
- the C++ JPEG decode equals `cv2.imread` exactly on JPEGs cv2 writes here
  at each sampling factor, with and without restart intervals, grayscale,
  odd and tiny sizes (hypothesis), on files of one scan per component
  (written here: cv2 writes one interleaved scan), and on the committed
  fixtures, whose recorded hashes chip_smoke.py checks on the card;
- a progressive JPEG, a truncated one, one without
  its EOI marker, an unknown PNG filter and a file of another format
  raise; `load_rgb` without cv2 picks the reader by the file's signature;
- a failed build raises (nothing falls back to the Python unfilter).
"""

import hashlib
import json
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dgod_tpu_torch.data import dataset, jpeg, native, png
from dgod_tpu_torch.utils.synthetic import png_filtered

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _cv2_rgb(data: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _image(rng, h, w, c):
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    img[h // 3:h // 2 + 1, w // 4:w // 2 + 1] = 200  # flat: the sums wrap
    return img


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 40), c=st.sampled_from([3, 4]),
       kinds=st.lists(st.integers(0, 4), min_size=1, max_size=6),
       seed=st.integers(0, 2**31 - 1))
def test_png_unfilter_matches_python_and_cv2(h, w, c, kinds, seed):
    img = _image(np.random.RandomState(seed), h, w, c)
    data = png_filtered(img, kinds)
    got = png.decode_png(data)
    np.testing.assert_array_equal(got, img[..., :3])
    np.testing.assert_array_equal(got, png.decode_png_plain(data))
    np.testing.assert_array_equal(got, _cv2_rgb(data))


def _cv2_jpeg(img, sampling, quality, restart):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_matches_cv2(sampling, restart, gray):
    rng = np.random.RandomState(len(sampling) + restart)
    img = _image(rng, 67, 93, 3)
    img = cv2.GaussianBlur(img, (5, 5), 0)  # a photograph's spectrum
    data = _cv2_jpeg(img[..., 0] if gray else img, sampling, 85, restart)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _cv2_rgb(data))


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 56),
       sampling=st.sampled_from(sorted(SAMPLING)),
       quality=st.sampled_from([20, 60, 90, 100]),
       restart=st.integers(0, 4), gray=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_jpeg_matches_cv2_at_any_size(h, w, sampling, quality, restart, gray,
                                      seed):
    img = _image(np.random.RandomState(seed), h, w, 3)
    data = _cv2_jpeg(img[..., 0] if gray else img, sampling, quality, restart)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _cv2_rgb(data))


_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
           38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


class _Bits:
    """Entropy-coded bits: MSB first, a 0x00 after each 0xFF, 1s to pad."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _encode_scans(h, w, comps, blocks, restart=0):
    """A baseline JPEG with one scan per component (non-interleaved, which
    cv2 never writes): comps [(id, h, v)], blocks[c] the quantized
    coefficients [block rows, block columns, 64] in natural order; every
    DC magnitude coded in 4 bits and every AC symbol in 8."""
    dc_syms = list(range(12))
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    dc_code = {s: i for i, s in enumerate(dc_syms)}   # all length 4
    ac_code = {s: i for i, s in enumerate(ac_syms)}   # all length 8
    q = (np.arange(64) % 8 + 1).astype(np.uint8)
    out = b"\xff\xd8"
    out += _segment(0xDB, bytes([0]) + bytes(q[_ZIGZAG]))
    sof = struct.pack(">BHHB", 8, h, w, len(comps))
    for cid, hs, vs in comps:
        sof += bytes([cid, (hs << 4) | vs, 0])
    out += _segment(0xC0, sof)
    bits = [0] * 17
    bits[4] = 12
    out += _segment(0xC4, bytes([0x00]) + bytes(bits[1:]) + bytes(dc_syms))
    bits = [0] * 17
    bits[8] = len(ac_syms)
    out += _segment(0xC4, bytes([0x10]) + bytes(bits[1:]) + bytes(ac_syms))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for (cid, hs, vs), blk in zip(comps, blocks):
        out += _segment(0xDA, bytes([1, cid, 0x00, 0, 63, 0]))
        bw = _Bits()
        pred, n, rst = 0, 0, 0
        for by in range(blk.shape[0]):
            for bx in range(blk.shape[1]):
                if restart and n and n % restart == 0:
                    bw.flush()
                    out += bytes(bw.out) + bytes([0xFF, 0xD0 + rst])
                    bw, pred, rst = _Bits(), 0, (rst + 1) & 7
                n += 1
                coef = blk[by, bx][_ZIGZAG]
                diff = int(coef[0]) - pred
                pred = int(coef[0])
                s, v = _magnitude(diff)
                bw.put(dc_code[s], 4)
                bw.put(v, s)
                run = 0
                for k in range(1, 64):
                    c = int(coef[k])
                    if c == 0:
                        run += 1
                        continue
                    while run > 15:
                        bw.put(ac_code[0xF0], 8)
                        run -= 16
                    s, v = _magnitude(c)
                    bw.put(ac_code[(run << 4) | s], 8)
                    bw.put(v, s)
                    run = 0
                if run:
                    bw.put(ac_code[0x00], 8)
        bw.flush()
        out += bytes(bw.out)
    return out + b"\xff\xd9"

@pytest.mark.parametrize("sampling", ["444", "420"])
def test_jpeg_one_scan_per_component_matches_cv2(sampling):
    """The decoder's non-interleaved path: one scan per component, each
    over the component's own blocks, with and without restart intervals."""
    rng = np.random.RandomState(len(sampling))
    comps = [(1, 2, 2) if sampling == "420" else (1, 1, 1), (2, 1, 1),
             (3, 1, 1)]
    top = comps[0][1]  # the largest factor, both ways

    def ceil(a, b):
        return -(-a // b)

    for h, w, restart in ((1, 1, 0), (23, 37, 0), (40, 17, 1), (33, 58, 3)):
        blocks = []
        for _, hs, vs in comps:  # each component's blocks, unpadded
            nb = (ceil(ceil(h * vs, top), 8), ceil(ceil(w * hs, top), 8))
            blk = np.zeros((*nb, 64), np.int32)
            blk[..., 0] = rng.randint(-60, 60, nb)
            blk[..., 1:] = np.where(rng.rand(*nb, 63) < 0.15,
                                    rng.randint(-30, 31, (*nb, 63)), 0)
            blocks.append(blk)
        data = _encode_scans(h, w, comps, blocks, restart)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), _cv2_rgb(data),
                                      err_msg=f"{h}x{w} restart {restart}")


def test_fixtures_match_their_recorded_cv2_hashes():
    hashes = json.loads((FIXTURES / "hashes.json").read_text())
    assert len(hashes) >= 10
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1 << 20
    for name, want in hashes.items():
        got = jpeg.read_jpeg(str(FIXTURES / name))
        ref = cv2.cvtColor(cv2.imread(str(FIXTURES / name)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
        assert list(got.shape) == want["shape"]


def test_what_the_readers_do_not_take_raises(tmp_path):
    img = cv2.GaussianBlur(_image(np.random.RandomState(0), 48, 64, 3),
                           (5, 5), 0)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok
    with pytest.raises(ValueError, match="progressive"):
        jpeg.decode_jpeg(buf.tobytes())
    data = _cv2_jpeg(img, "420", 90, 0)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:-2])  # no EOI marker
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"GIF89a" + data)
    rows = np.zeros((48, 1 + 64 * 3), np.uint8)
    rows[5, 0] = 7  # no such filter type
    bad = (png.SIGNATURE
           + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 64, 48, 8, 2, 0, 0, 0))
           + png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
           + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unknown PNG filter type 7"):
        png.decode_png(bad)


def test_load_rgb_without_cv2_reads_by_signature(tmp_path, monkeypatch):
    img = cv2.GaussianBlur(_image(np.random.RandomState(1), 30, 50, 3),
                           (3, 3), 0)
    (tmp_path / "x.png").write_bytes(png_filtered(img))
    (tmp_path / "y.jpg").write_bytes(_cv2_jpeg(img, "422", 90, 0))
    assert cv2.imwrite(str(tmp_path / "z.bmp"), img)
    refs = {n: dataset.load_rgb(str(tmp_path / n)) for n in ("x.png", "y.jpg")}
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name, ref in refs.items():
        np.testing.assert_array_equal(dataset.load_rgb(str(tmp_path / name)),
                                      ref)
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        dataset.load_rgb(str(tmp_path / "z.bmp"))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "image_decode.cpp"
    broken.write_text("this is not C++\n")
    lib = native.HostLibrary("image_decode", lambda lib: None)
    lib.src = broken
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        lib.get()
    assert not list((tmp_path / "_build").glob("*.so"))
