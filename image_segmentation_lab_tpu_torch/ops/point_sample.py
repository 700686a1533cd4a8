"""Point sampling (counterpart of ``ops/point_sample.py``).

``point_sample(feat, points)`` evaluates an NCHW map at normalized
``(x, y)`` points in [0, 1], as mmcv's ``point_sample`` (``F.grid_sample(
feat, 2 * points - 1, padding_mode='zeros')``) does: with
``align_corners=False`` a point maps to ``p * size - 0.5``, corners outside
the map count zero, ``mode='nearest'`` takes ``floor(px + 0.5)``.

It is written as the JAX function is: four bilinear taps read by one
``torch.gather`` over the flattened map, float32 weights (float64 for a
float64 map), the taps summed in float32 and the result cast to the map's
dtype.  Not ``F.grid_sample``: its CUDA backward adds with atomics and
raises under ``torch.use_deterministic_algorithms(True)``, which the kvasir
schedule sets; ``torch.gather``'s backward (a ``scatter_add``) has a
deterministic implementation under that flag.  A tap whose corner lies
outside the map reads a clamped in-map index and gets weight 0.

``calculate_uncertainty`` is mmseg's: minus the top-1/top-2 logit gap over
the channels (for one channel, minus ``|logit|``).
"""

from __future__ import annotations

import torch

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _unnormalize(p, size: int, align_corners: bool):
    if align_corners:
        return p * (size - 1)
    return p * size - 0.5


def point_sample(feat: torch.Tensor, points: torch.Tensor,
                 align_corners: bool = False,
                 mode: str = "bilinear") -> torch.Tensor:
    """Sample ``feat`` (N, C, H, W) at ``points`` (N, P, 2) (``(x, y)``
    order) -> (N, C, P)."""
    N, C, H, W = feat.shape
    acc = torch.promote_types(feat.dtype, torch.float32)
    flat = feat.reshape(N, C, H * W)
    px = _unnormalize(points[..., 0].to(acc), W, align_corners)
    py = _unnormalize(points[..., 1].to(acc), H, align_corners)

    if mode == "nearest":
        ix = torch.floor(px + 0.5).long()
        iy = torch.floor(py + 0.5).long()
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        out = flat.gather(2, idx[:, None].expand(N, C, -1))
        return torch.where(valid[:, None], out, out.new_zeros(()))

    assert mode == "bilinear", mode
    x0f, y0f = torch.floor(px), torch.floor(py)
    fx, fy = px - x0f, py - y0f
    x0, y0 = x0f.long(), y0f.long()
    idx, weights = [], []
    for dy, dx in _CORNERS:
        ix, iy = x0 + dx, y0 + dy
        inside = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        wy = fy if dy else 1.0 - fy
        wx = fx if dx else 1.0 - fx
        weights.append(wx * wy * inside.to(acc))
        idx.append(iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
    P = points.shape[1]
    idx = torch.cat(idx, dim=1)                             # (N, 4P)
    taps = flat.gather(2, idx[:, None].expand(N, C, 4 * P)).to(acc)
    taps = taps.view(N, C, 4, P)
    with torch.autocast(feat.device.type, enabled=False):
        out = taps[:, :, 0] * weights[0][:, None]
        for t in range(1, 4):
            out = out + taps[:, :, t] * weights[t][:, None]
    return out.to(feat.dtype)


def calculate_uncertainty(seg_logits: torch.Tensor) -> torch.Tensor:
    """Uncertainty of (N, C, ...) logits: minus the top-1/top-2 gap over
    C; for C == 1 minus the distance to the decision boundary."""
    if seg_logits.shape[1] == 1:
        return -seg_logits[:, 0].abs()
    top2 = torch.topk(seg_logits, 2, dim=1).values
    return top2[:, 1] - top2[:, 0]
