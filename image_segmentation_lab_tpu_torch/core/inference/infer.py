"""Offline inference API (counterpart of ``core/inference/infer.py``).

``init_model`` parses a network config, builds the segmentor, initialises
it from a fixed seed, loads a checkpoint of either package when given one,
and returns the module in eval mode on ``device`` (float32 with TF32 off:
``float32_precision``); ``inference_model`` turns images into class maps
at their original size: an image path is decoded (``fileio.imread``, RGB)
and, as an ``(H, W, C)`` array, run through the ``pipeline`` (a YAML path
or a ``data.Pipeline``, such as the val YAML: Resize, Normalize) where one
is given.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Union

import numpy as np
import torch

from ...data.pipeline import Pipeline
from ...models.builder import build_segmentor
from ..fileio import imread, parse_and_backup_config, require_config_key
from ..initialize import init_weights, load_checkpoint
from ..mixed_precision import float32_precision

ImageType = Union[str, Path, np.ndarray, torch.Tensor,
                  Sequence[Union[str, Path, np.ndarray]]]


def init_model(config: Union[str, Path], checkpoint=None,
               device: Union[str, torch.device] = "cuda"):
    """Build a segmentor from a network config (+ optional checkpoint).

    The module carries ``cfg`` (the network config) and ``classes`` /
    ``palette`` (from the checkpoint's metadata, else None)."""
    if not isinstance(config, (str, Path)):
        raise TypeError(f"config must be a file path, but got {type(config)}")
    network_config = require_config_key(parse_and_backup_config(config),
                                        "model", config)
    # inference never needs a pretrained-weights init
    if network_config.get("type") == "EncoderDecoder":
        if "init_cfg" in network_config.get("backbone", {}):
            network_config["backbone"]["init_cfg"] = None
    network_config["pretrained"] = None

    float32_precision()
    model = build_segmentor(network_config)
    init_weights(model, torch.Generator().manual_seed(0))
    model.cfg = network_config
    model.classes = model.palette = None
    if checkpoint is not None:
        meta = load_checkpoint(model, checkpoint).get("metadata") or {}
        if "CLASSES" in meta:
            model.classes, model.palette = meta["CLASSES"], meta.get("PALETTE")
    return model.to(device).eval()


@torch.no_grad()
def inference_model(model, img: ImageType,
                    pipeline: Union[str, Path, Pipeline, None] = None,
                    device: Union[str, torch.device, None] = None):
    """Class maps of ``img`` at its original size: one image (a path, or an
    ``(H, W, C)`` array) gives an ``(H, W)`` map, a list of them a list of
    maps, each image its own forward pass.  Without a ``pipeline`` the
    arrays are used as they are (already resized and normalised); an ``(N,
    H, W, C)`` array of such images is one forward pass and gives an ``(N,
    H, W)`` array.  ``device``: where the inputs go (the model's device by
    default); the pipeline draws from a generator seeded with 0."""
    device = torch.device(device) if device is not None else next(
        model.parameters()).device
    pipe = (Pipeline.from_yaml(pipeline) if isinstance(pipeline, (str, Path))
            else pipeline)
    if isinstance(img, (list, tuple)):
        return [inference_model(model, im, pipe, device) for im in img]
    if isinstance(img, (str, Path)):
        img = imread(img, channel_order="rgb")
    if pipe is not None:
        arr = np.asarray(img, dtype=np.float32)
        ori_size = arr.shape[:2]
        x, _ = pipe(torch.Generator(device=device).manual_seed(0), arr[None])
        pred = model.predict(x, ori_img_size=ori_size, rescale=True)
        return pred[0].cpu().numpy()
    x = torch.as_tensor(img, dtype=torch.float32, device=device)
    single = x.dim() == 3
    if single:
        x = x[None]
    pred = model.predict(x.permute(0, 3, 1, 2).contiguous())
    pred = pred.cpu().numpy()
    return pred[0] if single else pred
