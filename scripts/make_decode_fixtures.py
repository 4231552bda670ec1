#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's image decode, with OpenCV.

    python3 scripts/make_decode_fixtures.py [--out tests/fixtures/jpeg]

Each file is a seeded synthetic scene (colour gradients, flat boxes, mild
noise) that cv2.imencode writes at one sampling factor, quality and
restart interval; `hashes.json` records the sha256 and shape of what
`cv2.imread` gives for it, converted to RGB. The port's decoder must give
the same bytes (tests/test_torch_image_decode.py on the CPU, chip_smoke.py's
data phase on the card, where cv2 is absent). The cases cover 4:2:0, 4:2:2,
4:4:4 and 4:4:0 sampling, odd sizes, sizes of one to three pixels (libjpeg's
box upsampling), restart intervals, grayscale, and two files at BDD100K's
720x1280.
"""

import argparse
import hashlib
import json
import os

import cv2
import numpy as np

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}

# name: (height, width, sampling, quality, restart interval, grayscale)
CASES = {
    "s420_odd": (37, 53, "420", 90, 0, False),
    "s422_odd": (45, 31, "422", 85, 0, False),
    "s444": (64, 48, "444", 95, 0, False),
    "s440_odd": (29, 41, "440", 80, 0, False),
    "s420_restart": (99, 71, "420", 75, 2, False),
    "s422_restart": (40, 77, "422", 60, 1, False),
    "s420_narrow": (5, 3, "420", 90, 0, False),
    "s420_pixel": (1, 1, "420", 90, 0, False),
    "gray_odd": (41, 67, "420", 88, 0, True),
    "gray_restart": (24, 35, "420", 70, 3, True),
    "bdd_720x1280": (720, 1280, "420", 75, 0, False),
    "bdd_720x1280_q90": (720, 1280, "420", 90, 0, False),
}


def scene(h: int, w: int, seed: int, noise: int) -> np.ndarray:
    """RGB uint8: a gradient, a few flat boxes, +-noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c0, c1, c2 = rng.randint(0, 256, (3, 3)).astype(np.float32)
    img = (c0 + (c1 - c0) * (xx / max(w, 1))[..., None]
           + (c2 - c0) * (yy / max(h, 1))[..., None] * 0.5)
    for _ in range(rng.randint(2, 9)):
        bh, bw = rng.randint(1, max(h // 3, 2)), rng.randint(1, max(w // 3, 2))
        y, x = rng.randint(0, max(h - bh, 1)), rng.randint(0, max(w - bw, 1))
        img[y:y + bh, x:x + bw] = rng.randint(0, 256, 3)
    img += rng.randint(-noise, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests",
        "fixtures", "jpeg"))
    out = p.parse_args().out
    os.makedirs(out, exist_ok=True)
    hashes = {}
    for i, (name, (h, w, sampling, quality, restart, gray)) in enumerate(
            CASES.items()):
        # the BDD-sized files carry a photograph's entropy: ~100-300 KB
        rgb = scene(h, w, i, 20 if h * w >= 720 * 1280 else 6)
        src = rgb[..., 0] if gray else rgb[..., ::-1]  # cv2 writes BGR
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        if restart:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        path = os.path.join(out, f"{name}.jpg")
        if not cv2.imwrite(path, src, params):
            raise RuntimeError(f"cv2 could not write {path}")
        got = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        hashes[f"{name}.jpg"] = {
            "sha256": hashlib.sha256(got.tobytes()).hexdigest(),
            "shape": list(got.shape)}
    with open(os.path.join(out, "hashes.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(hashes)} files in {out}")


if __name__ == "__main__":
    main()
