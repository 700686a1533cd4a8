"""Offline inference API (counterpart of ``core/inference/infer.py``).

``init_model`` parses a network config, builds the segmentor, initialises
it from a fixed seed, loads a JAX-package checkpoint when given one, and
returns the module in eval mode on ``device``; ``inference_model`` turns
prepared images into class maps.  Images are float arrays or tensors that
have already been through the data pipeline (resize, normalise): image
paths and the YAML pipeline are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Union

import numpy as np
import torch

from ...models.builder import build_segmentor
from ..fileio import parse_and_backup_config, require_config_key
from ..initialize import init_weights, load_checkpoint

ImageType = Union[np.ndarray, torch.Tensor, Sequence[np.ndarray]]


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
def inference_model(model, img: ImageType):
    """Class maps for prepared images: one ``(H, W, C)`` image gives an
    ``(H, W)`` map, an ``(N, H, W, C)`` batch an ``(N, H, W)`` array (one
    forward pass), a list of images a list of maps."""
    if isinstance(img, (list, tuple)):
        return [inference_model(model, im) for im in img]
    if isinstance(img, (str, Path)):
        raise TypeError("image paths need the data pipeline, which is not "
                        "ported yet; pass prepared arrays")
    device = next(model.parameters()).device
    x = torch.as_tensor(img, dtype=torch.float32, device=device)
    single = x.dim() == 3
    if single:
        x = x[None]
    pred = model.predict(x.permute(0, 3, 1, 2).contiguous())
    pred = pred.cpu().numpy()
    return pred[0] if single else pred
