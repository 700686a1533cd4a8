"""Augmentation pipeline: an albumentations YAML -> batched transforms on
the device (counterpart of ``data/pipeline.py``).

It reads the YAML files the JAX package reads (``__version__`` and a
``transform`` tree of ``__class_fullname__`` nodes), through the port's
own reader (``albu_yaml``, no PyYAML), and builds them from
``data/transforms.py``.  A ``torch.Generator`` on the data's device takes
the place of the JAX package's PRNG key (parity at the level of the
distributions).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import albu_yaml
from .transforms import TRANSFORMS, Transform


def _build_node(node: Dict[str, Any]) -> Transform:
    node = dict(node)
    name = node.pop("__class_fullname__")
    # albumentations may write full dotted paths
    name = name.split(".")[-1]
    if name not in TRANSFORMS:
        raise KeyError(
            f"Transform '{name}' from the augmentation YAML has no on-device "
            f"implementation. Available: {sorted(TRANSFORMS)}")
    cls = TRANSFORMS[name]
    children = node.pop("transforms", None)
    if children is not None:
        built = [_build_node(c) for c in children]
        return cls(built, **_clean(node))
    return cls(**_clean(node))


def _clean(node: Dict[str, Any]) -> Dict[str, Any]:
    """Drop albumentations' bookkeeping keys."""
    for key in ("bbox_params", "keypoint_params", "additional_targets",
                "is_check_shapes"):
        node.pop(key, None)
    return node


def _on_device(array, device, dtype=None) -> torch.Tensor:
    """``array`` (numpy or a tensor) as a tensor on ``device``.  A tensor on
    another device than the generator's is refused: a CUDA batch never
    carries on on the CPU."""
    if isinstance(array, torch.Tensor):
        if array.device.type != torch.device(device).type:
            raise ValueError(f"the batch is on {array.device} but the "
                             f"generator on {device}")
        return array if dtype is None else array.to(dtype)
    return torch.as_tensor(np.asarray(array), dtype=dtype, device=device)


class Pipeline:
    """A batched augmentation pipeline on the generator's device."""

    def __init__(self, root: Transform):
        self.root = root

    @classmethod
    def from_yaml(cls, path) -> "Pipeline":
        spec = albu_yaml.load(path)
        if not isinstance(spec, dict) or "transform" not in spec:
            raise ValueError(f"Not an albumentations YAML: {path}")
        return cls(_build_node(spec["transform"]))

    @classmethod
    def from_dict(cls, spec: Dict[str, Any]) -> "Pipeline":
        return cls(_build_node(spec["transform"] if "transform" in spec
                               else spec))

    def output_shape(self, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The per-image ``(C, H, W)`` out of the pipeline."""
        return self.root.output_shape(in_shape)

    def batched_apply(self, generator: torch.Generator, images,
                      masks=None):
        """The batch transform: ``images (N, H, W, C)`` (uint8 as the
        loader gives them, or float), ``masks (N, H, W)`` or None, as
        arrays or tensors; they go to the generator's device as they are
        (uint8 stays uint8 for the copy), then to float32 NCHW in one
        kernel, through ``root.batched`` (OneOf and p < 1 branches
        stratified), and the masks back to int32."""
        device = generator.device
        images = _on_device(images, device)
        if images.dim() != 4 or images.shape[-1] > 4:
            raise ValueError(f"the pipeline takes images (N, H, W, C), got "
                             f"{tuple(images.shape)}")
        images = images.permute(0, 3, 1, 2).to(
            torch.float32, memory_format=torch.contiguous_format)
        if masks is not None:
            masks = _on_device(masks, device, torch.float32)
        images, masks = self.root.batched(generator, images, masks)
        return images, (None if masks is None else masks.to(torch.int32))

    def __call__(self, generator: torch.Generator, images, masks=None):
        """Float32 ``(N, C, H, W)`` images (normalised if the YAML ends in
        Normalize) and int32 masks (or None), on the generator's device;
        ``batched_apply`` without grad (the train step with a pipeline
        calls this)."""
        with torch.no_grad():
            return self.batched_apply(generator, images, masks)
