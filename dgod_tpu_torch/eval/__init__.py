from .coco_map import MeanAveragePrecision  # noqa: F401
