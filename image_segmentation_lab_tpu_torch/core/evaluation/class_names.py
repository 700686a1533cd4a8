"""Dataset class names and palettes by dataset name or alias (counterpart
of ``core/evaluation/class_names.py``)."""

from __future__ import annotations

from typing import List

from ._class_name_tables import DATASET_TABLES

dataset_aliases = {
    "cityscapes": ["cityscapes"],
    "ade": ["ade", "ade20k"],
    "voc": ["voc", "pascal_voc", "voc12", "voc12aug"],
    "cocostuff": ["cocostuff", "cocostuff10k", "cocostuff164k",
                  "coco-stuff", "coco-stuff10k", "coco-stuff164k",
                  "coco_stuff", "coco_stuff10k", "coco_stuff164k"],
    "loveda": ["loveda"],
    "potsdam": ["potsdam"],
    "vaihingen": ["vaihingen"],
    "isaid": ["isaid"],
    "stare": ["stare", "STARE"],
    "drive": ["drive", "DRIVE"],
    "chase_db1": ["chase_db1", "chasedb1", "CHASE_DB1"],
    "hrf": ["hrf", "HRF"],
    "occludedface": ["occludedface"],
}


def _resolve(dataset: str) -> str:
    for key, aliases in dataset_aliases.items():
        if dataset in aliases or dataset.lower() in aliases:
            return key
    raise ValueError(f"Unrecognized dataset: {dataset}. "
                     f"Known: {sorted(dataset_aliases)}")


def get_classes(dataset: str) -> List[str]:
    return list(DATASET_TABLES[_resolve(dataset)]["classes"])


def get_palette(dataset: str) -> List[List[int]]:
    return [list(p) for p in DATASET_TABLES[_resolve(dataset)]["palette"]]
