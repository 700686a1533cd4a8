"""Instance-result export as COCO-style uncompressed RLE (counterpart of
``core/evaluation/instances.py``; numpy on the host, a copy of the JAX
package's).

``MaskFormerHead.instance_results`` gives the (labels, scores, masks)
triple; these helpers turn the kept masks into COCO's ``{"size": [H, W],
"counts": [...]}`` uncompressed RLE.  The convention is pycocotools':
column-major (Fortran) pixel order, run lengths alternating from a count
of ZEROS (a mask whose first pixel is 1 starts with a 0 count).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def mask_to_rle(mask: np.ndarray) -> Dict[str, object]:
    """Binary (H, W) mask → COCO uncompressed RLE dict."""
    mask = np.asarray(mask).astype(bool)
    h, w = mask.shape
    flat = mask.ravel(order="F")
    # run boundaries; counts alternate starting with zeros
    changes = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    runs = np.diff(np.concatenate([[0], changes, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": counts}


def rle_to_mask(rle: Dict[str, object]) -> np.ndarray:
    """Inverse of :func:`mask_to_rle` (round-trip/regression helper)."""
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for count in rle["counts"]:
        if val:
            flat[pos:pos + count] = True
        pos += count
        val = not val
    return flat.reshape((h, w), order="F")


def instances_to_json(labels: np.ndarray, scores: np.ndarray,
                      masks: np.ndarray) -> List[Dict[str, object]]:
    """One image's (Q,) labels / (Q,) scores / (Q, H, W) masks →
    a list of COCO-style instance dicts, dropped where ``score == 0``
    (``instance_results`` zeroes gated queries) or the mask is empty,
    sorted by descending score."""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    masks = np.asarray(masks).astype(bool)
    out = []
    for q in np.argsort(-scores):
        if scores[q] <= 0 or not masks[q].any():
            continue
        out.append({"label": int(labels[q]),
                    "score": round(float(scores[q]), 6),
                    "segmentation": mask_to_rle(masks[q])})
    return out
