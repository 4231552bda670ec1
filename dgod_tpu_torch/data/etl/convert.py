"""Annotation ETL: dataset-native JSON -> unified CSV (the port's own copy
of dgod_tpu/data/etl/convert.py, with the stdlib `csv` module in place of
pandas: it writes the bytes `DataFrame.to_csv` writes, the unnamed index
column first, tests/test_torch_etl.py).

One parameterised converter replacing the reference's four near-duplicate
scripts (data/json2csv_{acdc,bdd10k,cityscapes,idd}.py). Output schema is
identical: CSV columns `image_name, BoxesString, LabelsString` with
';'-separated 'x1 y1 x2 y2' boxes and `no_box`/`no_label` sentinels
(producers at reference data/json2csv_cityscapes.py:28-44).

Shared 8-class taxonomy (reference data/json2csv_acdc.py:11):
person=1, rider=2, car=3, truck=4, bus=5, train=6, motorcycle=7, bicycle=8.

Source formats:
- acdc: COCO-style instancesonly json, xywh -> xyxy
  (reference data/json2csv_acdc.py:69-76)
- bdd10k: ins_seg poly2d vertices -> AABB (json2csv_bdd10k.py:54-73)
- cityscapes / idd: per-image gtFine *_polygons.json, polygon -> AABB
  (json2csv_cityscapes.py:67-112, json2csv_idd.py:49-86)

Usage:
  python -m dgod_tpu_torch.data.etl.convert --dataset cityscapes \
      --image_set train --data_root . --out Annots/
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

CLASS_IDS = {
    "person": 1, "rider": 2, "car": 3, "truck": 4,
    "bus": 5, "train": 6, "motorcycle": 7, "bicycle": 8,
}
CAR_ONLY_IDS = {"car": 1}


def encode_boxes(boxes) -> str:
    if not len(boxes):
        return "no_box"
    return ";".join(" ".join(str(float(v)) for v in b) for b in boxes)


def encode_labels(labels) -> str:
    if not len(labels):
        return "no_label"
    return ";".join(str(int(l)) for l in labels)


def polygon_to_box(polygon) -> list:
    p = np.asarray(polygon)
    return [
        int(np.min(p[:, 0])), int(np.min(p[:, 1])),
        int(np.max(p[:, 0])), int(np.max(p[:, 1])),
    ]


def rows_acdc(data_root: str, image_set: str, class_ids):
    path = os.path.join(
        data_root, "ACDC", "gt_detection",
        f"instancesonly_{image_set}_gt_detection.json",
    )
    with open(path) as f:
        coco = json.load(f)
    names = {c["id"]: c["name"] for c in coco["categories"]}
    per_image = {img["id"]: (img["file_name"], [], []) for img in coco["images"]}
    for ann in coco["annotations"]:
        name = names[ann["category_id"]]
        if name not in class_ids:
            continue
        x, y, w, h = ann["bbox"]
        file_name, boxes, labels = per_image[ann["image_id"]]
        boxes.append([x, y, x + w, y + h])
        labels.append(class_ids[name])
    for file_name, boxes, labels in per_image.values():
        yield file_name, boxes, labels


def rows_bdd10k(data_root: str, image_set: str, class_ids):
    path = os.path.join(data_root, "BDD100K", "labels", f"ins_seg_{image_set}.json")
    with open(path) as f:
        items = json.load(f)
    for item in items:
        boxes, labels = [], []
        for obj in item.get("labels", []):
            if obj.get("category") not in class_ids:
                continue
            poly = obj.get("poly2d", [])
            if not poly:
                continue
            vertices = np.asarray(poly[0]["vertices"])
            if vertices.size == 0:
                continue
            boxes.append(polygon_to_box(vertices))
            labels.append(class_ids[obj["category"]])
        yield item["name"], boxes, labels


def _rows_gtfine(images_dir: str, labels_dir: str, base_fn, class_ids):
    for city in sorted(os.listdir(images_dir)):
        city_dir = os.path.join(images_dir, city)
        if not os.path.isdir(city_dir):
            continue
        for fname in sorted(os.listdir(city_dir)):
            base = base_fn(fname)
            json_path = os.path.join(labels_dir, city, base + "_gtFine_polygons.json")
            with open(json_path) as f:
                data = json.load(f)
            boxes, labels = [], []
            for obj in data.get("objects", []):
                if obj.get("label") not in class_ids:
                    continue
                poly = np.asarray(obj.get("polygon", []))
                if poly.size == 0:
                    continue
                boxes.append(polygon_to_box(poly))
                labels.append(class_ids[obj["label"]])
            yield f"{city}/{fname}", boxes, labels


def rows_cityscapes(data_root: str, image_set: str, class_ids,
                    weather: str = "clear"):
    """Cityscapes gtFine polygons -> rows, optionally for the foggy/rain
    refined variants.

    The reference declares --weather clear|foggy|rain
    (json2csv_cityscapes.py:19-21) and notes the refined foggy/rain sets
    (:52) but never wires the flag into its paths — the variants are
    unproducible there. Here it is functional: foggy/rain read from
    `leftImg8bit_<weather>/` (the Foggy/Rain Cityscapes layout, e.g.
    `aachen_..._leftImg8bit_foggy_beta_0.01.png`), share the clear split's
    gtFine annotations, and write `cityscapes_<weather>_*` CSVs.

    The annotation base name is the first three '_'-separated fields of the
    filename (city_seq_frame), exactly the reference's extraction
    (json2csv_cityscapes.py:73-75) — suffix-agnostic, so one rule covers
    clear and every beta/alpha-suffixed weather rendering.
    """
    if weather not in ("clear", "foggy", "rain"):
        raise ValueError(f"weather must be clear|foggy|rain, got {weather!r}")
    img_subdir = "leftImg8bit" if weather == "clear" else f"leftImg8bit_{weather}"
    return _rows_gtfine(
        os.path.join(data_root, "Cityscapes", img_subdir, image_set),
        os.path.join(data_root, "Cityscapes", "gtFine", image_set),
        lambda fname: "_".join(fname.split("_")[:3]), class_ids,
    )


def rows_idd(data_root: str, image_set: str, class_ids):
    return _rows_gtfine(
        os.path.join(data_root, "IDD", "leftImg8bit", image_set),
        os.path.join(data_root, "IDD", "gtFine", image_set),
        lambda fname: fname.split(".")[0].split("_")[0], class_ids,
    )


GENERATORS = {
    "acdc": rows_acdc,
    "bdd10k": rows_bdd10k,
    "cityscapes": rows_cityscapes,
    "idd": rows_idd,
}


def convert(dataset: str, image_set: str, data_root: str = ".",
            out_dir: str = "Annots", category: str = "all",
            weather: str = "clear") -> str:
    class_ids = CLASS_IDS if category == "all" else CAR_ONLY_IDS
    if weather != "clear" and dataset != "cityscapes":
        raise ValueError("--weather applies to cityscapes only "
                         "(reference json2csv_cityscapes.py:19-21)")
    gen = GENERATORS[dataset]
    rows_iter = (gen(data_root, image_set, class_ids, weather=weather)
                 if dataset == "cityscapes" else
                 gen(data_root, image_set, class_ids))
    rows = [(name, encode_boxes(boxes), encode_labels(labels))
            for name, boxes, labels in rows_iter]
    os.makedirs(out_dir, exist_ok=True)
    tag = dataset if weather == "clear" else f"{dataset}_{weather}"
    out_path = os.path.join(out_dir, f"{tag}_{image_set}_{category}.csv")
    write_csv(out_path, rows)
    return out_path


def write_csv(path: str, rows) -> None:
    """(image_name, BoxesString, LabelsString) rows as `DataFrame.to_csv`
    writes them: an unnamed index column of row numbers first, the stdlib
    writer's minimal quoting (pandas writes through it too), os.linesep
    after each line."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator=os.linesep)
        writer.writerow(["", "image_name", "BoxesString", "LabelsString"])
        writer.writerows([i, *row] for i, row in enumerate(rows))


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert annotations to CSV")
    p.add_argument("--dataset", choices=sorted(GENERATORS), required=True)
    p.add_argument("--image_set", default="train", help="train or val")
    p.add_argument("--category", default="all", help="all or car")
    p.add_argument("--weather", default="clear",
                   choices=["clear", "foggy", "rain"],
                   help="cityscapes only: clear, foggy, rain "
                        "(refined weather variants)")
    p.add_argument("--data_root", default=".")
    p.add_argument("--out", dest="out_dir", default="Annots")
    args = p.parse_args(argv)
    path = convert(args.dataset, args.image_set, args.data_root, args.out_dir,
                   args.category, args.weather)
    print(path)


if __name__ == "__main__":
    main()
