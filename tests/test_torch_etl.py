"""The port's annotation converter (dgod_tpu_torch/data/etl/convert.py,
stdlib csv) writes the bytes the JAX package's (pandas' `to_csv`) writes,
for each dataset, category and weather, on the trees tests/test_etl.py
builds, with an IDD tree, names that need quoting and an empty split
added; the helpers and flags are the same."""

import json
import os
import subprocess
import sys

import pytest

from dgod_tpu.data.etl import convert as J
from dgod_tpu_torch.data.etl import convert as P


def _acdc(root):
    gt = root / "ACDC" / "gt_detection"
    gt.mkdir(parents=True)
    coco = {
        "images": [{"id": 1, "file_name": "fog/img1.png"},
                   {"id": 2, "file_name": "fog/img2.png"},
                   {"id": 3, "file_name": 'rain/a,"b".png'}],
        "categories": [{"id": 10, "name": "car"}, {"id": 11, "name": "person"},
                       {"id": 12, "name": "sky"}],
        "annotations": [
            {"image_id": 1, "category_id": 10, "bbox": [10, 20, 30, 40]},
            {"image_id": 1, "category_id": 11, "bbox": [0, 0, 5, 5]},
            {"image_id": 3, "category_id": 10, "bbox": [1.5, 2, 3.25, 4]},
            {"image_id": 3, "category_id": 12, "bbox": [0, 0, 9, 9]},
        ],
    }
    (gt / "instancesonly_train_gt_detection.json").write_text(json.dumps(coco))


def _gtfine(root, dataset, img_subdir, fname, base, objects):
    img_dir = root / dataset / img_subdir / "train" / "aachen"
    gt_dir = root / dataset / "gtFine" / "train" / "aachen"
    img_dir.mkdir(parents=True, exist_ok=True)
    gt_dir.mkdir(parents=True, exist_ok=True)
    (img_dir / fname).write_bytes(b"")
    (gt_dir / f"{base}_gtFine_polygons.json").write_text(
        json.dumps({"objects": objects}))


def _cityscapes(root):
    _gtfine(root, "Cityscapes", "leftImg8bit",
            "aachen_000000_000019_leftImg8bit.png", "aachen_000000_000019",
            [{"label": "car", "polygon": [[100, 200], [150, 180], [120, 260]]},
             {"label": "sky", "polygon": [[0, 0], [10, 10]]},
             {"label": "person", "polygon": [[5, 6], [50, 60], [20, 90]]}])
    _gtfine(root, "Cityscapes", "leftImg8bit",
            "aachen_000001_000019_leftImg8bit.png", "aachen_000001_000019",
            [{"label": "road", "polygon": [[0, 0], [3, 3]]}])


def _foggy(root):
    _gtfine(root, "Cityscapes", "leftImg8bit_foggy",
            "aachen_000000_000019_leftImg8bit_foggy_beta_0.01.png",
            "aachen_000000_000019",
            [{"label": "person", "polygon": [[5, 6], [50, 60], [20, 90]]},
             {"label": "car", "polygon": [[7, 8], [9, 30]]}])


def _idd(root):
    _gtfine(root, "IDD", "leftImg8bit", "000123_leftImg8bit.png", "000123",
            [{"label": "car", "polygon": [[3, 4], [30, 40], [10, 44]]},
             {"label": "motorcycle", "polygon": [[1, 1], [2, 9]]},
             {"label": "car", "polygon": []}])


def _bdd(root):
    lab = root / "BDD100K" / "labels"
    lab.mkdir(parents=True)
    data = [{"name": "x.jpg", "labels": [
        {"category": "bus", "poly2d": [{"vertices": [[1, 2], [11, 22]]}]},
        {"category": "car", "poly2d": [{"vertices": [[4, 2], [1, 9]]}]},
        {"category": "road", "poly2d": [{"vertices": [[0, 0]]}]},
        {"category": "car", "poly2d": []},
    ]}, {"name": "empty.jpg", "labels": []}]
    (lab / "ins_seg_val.json").write_text(json.dumps(data))


CASES = {  # name: (writes the tree, dataset, split, weather)
    "acdc": (_acdc, "acdc", "train", "clear"),
    "bdd10k": (_bdd, "bdd10k", "val", "clear"),
    "cityscapes": (_cityscapes, "cityscapes", "train", "clear"),
    "cityscapes_foggy": (_foggy, "cityscapes", "train", "foggy"),
    "idd": (_idd, "idd", "train", "clear"),
}


@pytest.mark.parametrize("category", ["all", "car"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_writes_the_jax_converters_bytes(tmp_path, case, category):
    build, dataset, split, weather = CASES[case]
    build(tmp_path)
    paths = [m.convert(dataset, split, str(tmp_path), str(tmp_path / out),
                       category, weather)
             for m, out in ((J, "jax"), (P, "port"))]
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        ref, got = a.read(), b.read()
    assert got == ref
    assert got.startswith(b",image_name,BoxesString,LabelsString")


def test_empty_split_and_helpers(tmp_path):
    (tmp_path / "BDD100K" / "labels").mkdir(parents=True)
    (tmp_path / "BDD100K" / "labels" / "ins_seg_train.json").write_text("[]")
    a = J.convert("bdd10k", "train", str(tmp_path), str(tmp_path / "j"))
    b = P.convert("bdd10k", "train", str(tmp_path), str(tmp_path / "p"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for fn, arg in ((P.encode_boxes, []), (P.encode_boxes, [[1, 2.5, 3, 4]]),
                    (P.encode_labels, []), (P.encode_labels, [1, 8]),
                    (P.polygon_to_box, [[10, 5], [2, 20], [15, 8]])):
        assert fn(arg) == getattr(J, fn.__name__)(arg)
    assert P.CLASS_IDS == J.CLASS_IDS and P.CAR_ONLY_IDS == J.CAR_ONLY_IDS
    with pytest.raises(ValueError, match="cityscapes only"):
        P.convert("bdd10k", "val", str(tmp_path), str(tmp_path / "p"),
                  weather="foggy")


def test_cli_runs_without_pandas(tmp_path):
    _bdd(tmp_path)
    code = ("import sys\n"
            "sys.modules['pandas'] = None\n"
            "from dgod_tpu_torch.data.etl import convert\n"
            "convert.main(sys.argv[1:])\n")
    out = subprocess.run(
        [sys.executable, "-c", code, "--dataset", "bdd10k", "--image_set",
         "val", "--data_root", str(tmp_path), "--out", str(tmp_path / "o")],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("bdd10k_val_all.csv")
