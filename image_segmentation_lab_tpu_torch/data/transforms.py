"""Batched augmentation transforms on the device (counterpart of
``data/transforms.py``).

The JAX package re-implements every transform of the albumentations YAMLs
as JAX ops, vmapped over the batch inside the train step.  The port runs
the same transforms as PyTorch ops on whole batches:

* images are ``(N, C, H, W)`` float32 (0..255 before ``Normalize``),
  masks ``(N, H, W)`` float32 or None;
* randomness comes only from an explicit ``torch.Generator`` on the data's
  device;
* a leaf transform is ``sample(generator, n, shape) -> params`` (its
  per-image parameters as tensors) and ``apply(imgs, masks, params)``,
  which is deterministic: tests inject parameters through ``apply``;
* per-image semantics (JAX: vmap of ``__call__``) are the same ``apply``
  with per-image parameter tensors, the ``p`` gate a per-image select;
  there is no Python loop over images;
* ``batched`` runs OneOf branches and ``p < 1`` leaves stratified, as the
  JAX package does: a random permutation gives branch ``i`` a sub-batch of
  ``_apportion(n, weights)[i]`` images, which runs that branch alone, and
  the permutation is undone.  ``ISLT_NO_STRATIFIED_ONEOF=1`` switches to
  the per-image path, as it does for the JAX package.

Each leaf's work runs under ``torch.profiler.record_function`` with the
transform's name, so a profile splits the pipeline by transform (the
ranges cost nothing without a profiler).

Shape-changing transforms (Resize, RandomCrop, PadIfNeeded) need p = 1.
GlassBlur's displacement is a parallel gather with clamped indices, as in
the JAX package (which computes the same values as a select-sum).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..utils.ops import resize

Params = Dict[str, torch.Tensor]


def _stratify_enabled() -> bool:
    """Stratified batched execution (``OneOf.batched``); the JAX package's
    switch ``ISLT_NO_STRATIFIED_ONEOF=1`` turns it off here too."""
    return not os.environ.get("ISLT_NO_STRATIFIED_ONEOF")


def _apportion(n: int, weights: Sequence[float]) -> List[int]:
    """Largest-remainder apportionment of ``n`` slots over ``weights``:
    ``|counts[i] / n - w_i| < 1 / n``."""
    total = float(sum(weights))
    quotas = [n * w / total for w in weights]
    counts = [int(q) for q in quotas]
    rem = n - sum(counts)
    order = sorted(range(len(weights)), key=lambda i: quotas[i] - counts[i],
                   reverse=True)
    for i in order[:rem]:
        counts[i] += 1
    return counts


def _stratify_representable(n: int, weights: Sequence[float]) -> bool:
    """Stratified execution is faithful only when every branch of nonzero
    weight gets a slot (ISONoise at p = 0.1 gets none at batch 4, and would
    never fire); otherwise the caller selects per image."""
    counts = _apportion(n, weights)
    return all(c > 0 for c, w in zip(counts, weights) if w > 1e-9)


def _rand(generator: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def _uniform(generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * _rand(generator, n)


def _randint(generator, lo: int, hi: int, *shape) -> torch.Tensor:
    """int64 draws in ``[lo, hi)``."""
    return torch.randint(lo, hi, shape, generator=generator,
                         device=generator.device)


def _select(gate: torch.Tensor, new, old):
    """Per image: ``new`` where ``gate``, else ``old``."""
    if new is None:
        return None
    return torch.where(gate.view(-1, *([1] * (new.dim() - 1))), new, old)


def _stratified_branches(generator, imgs, masks, branch_fns, weights):
    """Mutually exclusive branches on sub-batches of static size.

    A random permutation assigns each image to one branch; branch ``i``
    (``None``: identity) runs unconditionally on ``_apportion(n,
    weights)[i]`` images, and its results go back to their images' places,
    so the batch keeps its order."""
    n = imgs.shape[0]
    counts = _apportion(n, weights)
    perm = torch.randperm(n, generator=generator, device=imgs.device)
    out_i = imgs.clone()
    out_m = None if masks is None else masks.clone()
    off = 0
    for fn, c in zip(branch_fns, counts):
        if c and fn is not None:
            sel = perm[off:off + c]
            oi, om = fn(generator, imgs.index_select(0, sel),
                        None if masks is None else masks.index_select(0, sel))
            out_i.index_copy_(0, sel, oi)
            if masks is not None:
                out_m.index_copy_(0, sel, om)
        off += c
    return out_i, out_m


class Transform:
    """Base transform; subclasses take their fields from YAML kwargs."""

    p: float = 0.5

    def __init__(self, p: float = 0.5, **kwargs):
        self.p = float(p)
        self._extra = kwargs  # unknown albumentations fields are ignored

    def output_shape(self, shape):
        """The per-image ``(C, H, W)`` after this transform."""
        return tuple(shape)

    def sample(self, generator: torch.Generator, n: int, shape) -> Params:
        """Per-image parameters of ``n`` images of ``shape`` (C, H, W)."""
        return {}

    def apply(self, imgs, masks, params: Params):
        raise NotImplementedError

    def force_apply(self, generator, imgs, masks):
        """Apply to every image: a container (OneOf) picked this transform,
        so its own ``p`` gate is bypassed (albumentations'
        ``force_apply=True``).  Containers bypass only their own gate."""
        with record_function(type(self).__name__):
            params = self.sample(generator, imgs.shape[0],
                                 tuple(imgs.shape[1:]))
            return self.apply(imgs, masks, params)

    def __call__(self, generator, imgs, masks):
        """Per-image semantics: each image is transformed with probability
        ``p`` (the transform computes for all and a select keeps it)."""
        if self.p >= 1.0:
            return self.force_apply(generator, imgs, masks)
        gate = _rand(generator, imgs.shape[0]) < self.p
        new_i, new_m = self.force_apply(generator, imgs, masks)
        if new_i.shape != imgs.shape:
            raise ValueError(f"{type(self).__name__} changes shape; it "
                             f"needs p = 1")
        return _select(gate, new_i, imgs), _select(gate, new_m, masks)

    def batched(self, generator, imgs, masks):
        """Apply to a batch: a shape-preserving ``p < 1`` transform runs
        stratified (on a sub-batch of ``_apportion(n, [p, 1 - p])[0]``
        images) where that is enabled and representable, else per image."""
        weights = [self.p, 1.0 - self.p]
        if (self.p < 1.0 and _stratify_enabled() and imgs.shape[0] > 1
                and _stratify_representable(imgs.shape[0], weights)
                and self.output_shape(imgs.shape[1:])
                == tuple(imgs.shape[1:])):
            return _stratified_branches(generator, imgs, masks,
                                        [self.force_apply, None], weights)
        return self(generator, imgs, masks)


class Compose(Transform):

    def __init__(self, transforms: List[Transform], p: float = 1.0, **kw):
        super().__init__(p=p)
        self.transforms = transforms

    def output_shape(self, shape):
        for t in self.transforms:
            shape = t.output_shape(shape)
        return tuple(shape)

    def force_apply(self, generator, imgs, masks):
        # the Compose's own gate is bypassed; children keep theirs
        for t in self.transforms:
            imgs, masks = t(generator, imgs, masks)
        return imgs, masks

    def __call__(self, generator, imgs, masks):
        if self.p >= 1.0:
            return self.force_apply(generator, imgs, masks)
        # a nested Compose with p < 1 skips the whole block per image
        gate = _rand(generator, imgs.shape[0]) < self.p
        out_i, out_m = self.force_apply(generator, imgs, masks)
        if out_i.shape != imgs.shape:
            raise ValueError("a Compose with p < 1 must not change shapes")
        return _select(gate, out_i, imgs), _select(gate, out_m, masks)

    def batched(self, generator, imgs, masks):
        if self.p < 1.0:  # rare: exact per-image semantics for the block
            return self(generator, imgs, masks)
        for t in self.transforms:
            imgs, masks = t.batched(generator, imgs, masks)
        return imgs, masks


class OneOf(Transform):
    """Pick one child per image weighted by its p, then apply it
    unconditionally (albumentations OneOf), all gated by the OneOf's own
    p."""

    def __init__(self, transforms: List[Transform], p: float = 1.0, **kw):
        super().__init__(p=p)
        self.transforms = transforms
        ps = np.asarray([t.p for t in transforms], np.float32)
        self.probs = ps / ps.sum()

    def force_apply(self, generator, imgs, masks):
        """Per image: every child computes for the whole batch and a select
        keeps each image's pick (the JAX package's vmapped switch)."""
        probs = torch.as_tensor(self.probs, device=imgs.device)
        choice = torch.multinomial(probs, imgs.shape[0], replacement=True,
                                   generator=generator)
        out_i, out_m = imgs, masks
        for b, t in enumerate(self.transforms):
            new_i, new_m = t.force_apply(generator, imgs, masks)
            out_i = _select(choice == b, new_i, out_i)
            out_m = _select(choice == b, new_m, out_m)
        return out_i, out_m

    def batched(self, generator, imgs, masks):
        """Stratified: each child runs only on the sub-batch that picked
        it; per image where that is disabled or not representable."""
        fns = [t.force_apply for t in self.transforms]
        weights = [float(w) for w in self.probs]
        if self.p < 1.0:  # the OneOf's own gate: an identity branch
            weights = [w * self.p for w in weights] + [1.0 - self.p]
            fns = fns + [None]
        if (not _stratify_enabled() or imgs.shape[0] <= 1
                or not _stratify_representable(imgs.shape[0], weights)):
            return self(generator, imgs, masks)
        for t in self.transforms:
            if t.output_shape(imgs.shape[1:]) != tuple(imgs.shape[1:]):
                raise ValueError(f"OneOf child {type(t).__name__} changes "
                                 f"shape")
        return _stratified_branches(generator, imgs, masks, fns, weights)


# --------------------------------------------------------------- geometry

class Resize(Transform):

    def __init__(self, height: int, width: int, interpolation: int = 1,
                 mask_interpolation: int = 0, p: float = 1.0, **kw):
        super().__init__(p=p)
        self.height, self.width = int(height), int(width)
        # 0 = nearest, 1 = bilinear; cv2's other codes are not implemented
        if interpolation not in (0, 1) or mask_interpolation not in (0, 1):
            raise ValueError(f"only nearest (0) and bilinear (1) "
                             f"interpolation are implemented, got "
                             f"{interpolation}/{mask_interpolation}")
        self.interpolation = interpolation
        self.mask_interpolation = mask_interpolation

    def output_shape(self, shape):
        return (shape[0], self.height, self.width)

    def apply(self, imgs, masks, params):
        size = (self.height, self.width)
        # the same size is the identity for both interpolations (the loader
        # resizes on the host, so the pipeline on the device meets this)
        if tuple(imgs.shape[2:]) != size:
            imgs = resize(imgs, size, mode=("bilinear" if self.interpolation
                                            else "nearest"),
                          align_corners=False, warning=False)
        if masks is not None and tuple(masks.shape[1:]) != size:
            masks = resize(masks[:, None], size,
                           mode=("bilinear" if self.mask_interpolation
                                 else "nearest"),
                           align_corners=False, warning=False)[:, 0]
        return imgs, masks


class HorizontalFlip(Transform):
    def apply(self, imgs, masks, params):
        return imgs.flip(3), (None if masks is None else masks.flip(2))


class VerticalFlip(Transform):
    def apply(self, imgs, masks, params):
        return imgs.flip(2), (None if masks is None else masks.flip(1))


def _border_index(i, n: int, border_mode: int):
    """Map indices onto [0, n) per cv2's border mode: 1 = REPLICATE
    clamps; 2 = REFLECT (gfedcb|abcdefgh|gfedcba), period 2n; 4 =
    REFLECT_101 (gfedcb|abcdefgh|gfedcb), period 2(n - 1).  0 = CONSTANT
    is the caller's (a mask and the fill)."""
    if border_mode == 1:
        return i.clamp(0, n - 1)
    if border_mode == 2:
        m = torch.remainder(i, 2 * n)
        return torch.where(m >= n, 2 * n - 1 - m, m)
    if border_mode == 4:
        if n == 1:
            return torch.zeros_like(i)
        m = torch.remainder(i, 2 * (n - 1))
        return torch.where(m >= n, 2 * (n - 1) - m, m)
    raise ValueError(f"unsupported cv2 border_mode {border_mode}")


def _taps(planes, iy, ix, border_mode: int, fill: float):
    """``planes (N, C, H, W)`` at integer coordinates ``iy, ix (N, h,
    w)``, one gather over every image and channel; outside the image the
    border mode's value (0: ``fill``)."""
    n, c, h_in, w_in = planes.shape
    if border_mode == 0:
        inside = (iy >= 0) & (iy < h_in) & (ix >= 0) & (ix < w_in)
        iy, ix = iy.clamp(0, h_in - 1), ix.clamp(0, w_in - 1)
    else:
        iy = _border_index(iy, h_in, border_mode)
        ix = _border_index(ix, w_in, border_mode)
    flat = (iy * w_in + ix).view(n, 1, -1).expand(n, c, -1)
    out = planes.reshape(n, c, -1).gather(2, flat).view(n, c, *iy.shape[1:])
    if border_mode == 0:
        out = torch.where(inside[:, None], out, torch.full_like(out, fill))
    return out


def _affine_sample_pair(imgs, masks, inv, center, fill, fill_mask,
                        border_mode):
    """Warp by the per-image inverse matrices ``inv (N, 2, 2)`` about
    ``center``: bilinear taps for the images (summed in the JAX package's
    order), the nearest tap (round half to even) for the masks."""
    n, _, h, w = imgs.shape
    ys = torch.arange(h, dtype=torch.float32, device=imgs.device) - center[0]
    xs = torch.arange(w, dtype=torch.float32, device=imgs.device) - center[1]
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    a = inv.view(n, 2, 2, 1, 1)
    src_y = a[:, 0, 0] * yy + a[:, 0, 1] * xx + center[0]
    src_x = a[:, 1, 0] * yy + a[:, 1, 1] * xx + center[1]
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = src_y - y0, src_x - x0
    y0, x0 = y0.long(), x0.long()
    out = 0.0
    for dy, wyy in ((0, 1 - wy), (1, wy)):
        for dx, wxx in ((0, 1 - wx), (1, wx)):
            out = out + _taps(imgs, y0 + dy, x0 + dx, border_mode,
                              fill) * (wyy * wxx)[:, None]
    if masks is None:
        return out, None
    m = _taps(masks[:, None], torch.round(src_y).long(),
              torch.round(src_x).long(), border_mode, fill_mask)
    return out, m[:, 0]


class Rotate(Transform):
    """A rotation by a per-image angle from ``limit`` (degrees, positive
    counter-clockwise), sampled at the inverse-rotated grid: bilinear image
    taps, nearest mask taps, cv2 border modes 0/1/2/4.  The default border
    mode is albumentations 2.0.6's, CONSTANT (0)."""

    def __init__(self, limit=(-90, 90), interpolation: int = 1,
                 border_mode: int = 0, fill: float = 0.0,
                 fill_mask: float = 0.0, mask_interpolation: int = 0,
                 p: float = 0.5, **kw):
        super().__init__(p=p)
        self.limit = (limit, -limit) if isinstance(limit, (int, float)) \
            else tuple(limit)
        if interpolation != 1 or mask_interpolation != 0:
            raise ValueError(
                f"only interpolation=1 (bilinear) with mask_interpolation=0 "
                f"(nearest) is implemented, got {interpolation}/"
                f"{mask_interpolation}")
        if border_mode not in (0, 1, 2, 4):
            raise ValueError(f"unsupported cv2 border_mode {border_mode}")
        self.border_mode = int(border_mode)
        self.fill = float(fill)
        self.fill_mask = float(fill_mask)

    def sample(self, generator, n, shape):
        return {"angle": _uniform(generator, n, min(self.limit),
                                  max(self.limit))}

    def apply(self, imgs, masks, params):
        angle = params["angle"] * math.pi / 180.0
        c, s = torch.cos(angle), torch.sin(angle)
        inv = torch.stack([torch.stack([c, s], -1),
                           torch.stack([-s, c], -1)], -2)
        center = ((imgs.shape[2] - 1) / 2.0, (imgs.shape[3] - 1) / 2.0)
        return _affine_sample_pair(imgs, masks, inv, center, self.fill,
                                   self.fill_mask, self.border_mode)


class RandomCrop(Transform):

    def __init__(self, height: int, width: int, p: float = 1.0, **kw):
        super().__init__(p=p)
        self.height, self.width = int(height), int(width)

    def output_shape(self, shape):
        return (shape[0], self.height, self.width)

    def sample(self, generator, n, shape):
        _, h, w = shape
        return {"y0": _randint(generator, 0, max(h - self.height, 0) + 1, n),
                "x0": _randint(generator, 0, max(w - self.width, 0) + 1, n)}

    def apply(self, imgs, masks, params):
        dev = imgs.device
        iy = params["y0"][:, None, None] + torch.arange(
            self.height, device=dev)[None, :, None]
        ix = params["x0"][:, None, None] + torch.arange(
            self.width, device=dev)[None, None, :]
        shape = (imgs.shape[0], self.height, self.width)
        iy, ix = iy.expand(shape), ix.expand(shape)
        imgs = _taps(imgs, iy, ix, 1, 0.0)
        if masks is not None:
            masks = _taps(masks[:, None], iy, ix, 1, 0.0)[:, 0]
        return imgs, masks


class PadIfNeeded(Transform):
    """albumentations' defaults: border_mode 4 (REFLECT_101), masks padded
    with 0."""

    def __init__(self, min_height: int, min_width: int, fill: float = 0.0,
                 fill_mask: float = 0.0, border_mode: int = 4,
                 p: float = 1.0, **kw):
        super().__init__(p=p)
        self.min_height, self.min_width = int(min_height), int(min_width)
        self.fill, self.fill_mask = float(fill), float(fill_mask)
        if border_mode not in (0, 1, 2, 4):
            raise ValueError(f"unsupported cv2 border_mode {border_mode}")
        self.border_mode = int(border_mode)

    def output_shape(self, shape):
        return (shape[0], max(shape[1], self.min_height),
                max(shape[2], self.min_width))

    def apply(self, imgs, masks, params):
        n, _, h, w = imgs.shape
        ph = max(self.min_height - h, 0)
        pw = max(self.min_width - w, 0)
        dev = imgs.device
        iy = torch.arange(-(ph // 2), h + ph - ph // 2, device=dev)
        ix = torch.arange(-(pw // 2), w + pw - pw // 2, device=dev)
        shape = (n, iy.numel(), ix.numel())
        iy, ix = iy[None, :, None].expand(shape), ix[None, None, :].expand(
            shape)
        imgs = _taps(imgs, iy, ix, self.border_mode, self.fill)
        if masks is not None:
            masks = _taps(masks[:, None], iy, ix, self.border_mode,
                          self.fill_mask)[:, 0]
        return imgs, masks


# ------------------------------------------------------------------ blurs

def _depthwise_blur(imgs, kernels):
    """Correlate every channel of ``imgs (N, C, H, W)`` with ``kernels``
    ``(kh, kw)`` (one for the batch) or ``(N, kh, kw)`` (one an image), over
    reflect-101 padding (cv2's BORDER_DEFAULT, which albumentations' blurs
    inherit): one grouped convolution for the batch."""
    n, c, h, w = imgs.shape
    kh, kw = kernels.shape[-2:]
    x = F.pad(imgs, (kw // 2, kw // 2, kh // 2, kh // 2), mode="reflect")
    if kernels.dim() == 2:
        weight = kernels.expand(c, 1, kh, kw)
        return F.conv2d(x, weight, groups=c)
    weight = kernels.repeat_interleave(c, dim=0)[:, None]
    out = F.conv2d(x.reshape(1, n * c, *x.shape[2:]), weight, groups=n * c)
    return out.view(n, c, h, w)


def _odd_sizes(blur_limit) -> Tuple[int, int]:
    lim = ((3, blur_limit) if isinstance(blur_limit, (int, float))
           else tuple(int(v) for v in blur_limit))
    return max(int(lim[0]) | 1, 3), int(lim[1]) | 1


def _size_index(generator, n, kmin, kmax):
    """Per image, the index of an odd kernel size in [kmin, kmax]."""
    return _randint(generator, 0, (kmax - kmin) // 2 + 1, n)


def _masked_box_kernel(size, kmax: int):
    """Box kernels of the odd ``size (N,)`` embedded in a (kmax, kmax)
    grid."""
    r = torch.div(size - 1, 2, rounding_mode="floor")
    ii = (torch.arange(kmax, device=size.device) - kmax // 2).abs()
    inside = ((ii[None, :, None] <= r[:, None, None])
              & (ii[None, None, :] <= r[:, None, None]))
    kernel = inside.to(torch.float32)
    return kernel / kernel.sum(dim=(1, 2), keepdim=True)


class Blur(Transform):

    def __init__(self, blur_limit=(3, 7), p: float = 0.5, **kw):
        super().__init__(p=p)
        self.kmin, self.kmax = _odd_sizes(blur_limit)

    def sample(self, generator, n, shape):
        return {"size": self.kmin + 2 * _size_index(generator, n, self.kmin,
                                                    self.kmax)}

    def apply(self, imgs, masks, params):
        return _depthwise_blur(imgs, _masked_box_kernel(params["size"],
                                                        self.kmax)), masks


class GaussianBlur(Transform):
    """albumentations semantics: an odd ksize from ``blur_limit``; with
    ``sigma_limit`` 0, cv2's getGaussianKernel (fixed binomial rows up to
    7, else sigma ``0.3*((ksize-1)*0.5 - 1) + 0.8``), else a sigma uniform
    in the limit.  Embedded in a (kmax, kmax) grid."""

    # cv2 getGaussianKernel(ksize, sigma <= 0) for ksize <= 7
    _CV2_SMALL_GAUSS = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
            0.03125]}

    def __init__(self, blur_limit=(3, 7), sigma_limit=(0.0, 0.0),
                 p: float = 0.5, **kw):
        super().__init__(p=p)
        self.kmin, self.kmax = _odd_sizes(blur_limit)
        if self.kmax < self.kmin:
            raise ValueError(
                f"GaussianBlur blur_limit={blur_limit} resolves to an "
                f"empty kernel-size range [{self.kmin}, {self.kmax}]; "
                f"sigma-derived kernel sizes (blur_limit=0) are not "
                f"implemented: give an explicit odd range like (3, 7)")
        self.sigma_limit = ((0.0, sigma_limit) if isinstance(
            sigma_limit, (int, float)) else tuple(sigma_limit))

    def _sigma0_row(self, ksize: int) -> np.ndarray:
        if ksize in self._CV2_SMALL_GAUSS:
            v = np.asarray(self._CV2_SMALL_GAUSS[ksize], np.float32)
        else:
            sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
            x = np.arange(ksize) - (ksize - 1) / 2.0
            v = np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)
            v /= v.sum()
        pad = (self.kmax - ksize) // 2
        return np.pad(v, (pad, pad))

    def sample(self, generator, n, shape):
        return {"index": _size_index(generator, n, self.kmin, self.kmax),
                "sigma": _uniform(generator, n, *self.sigma_limit)}

    def apply(self, imgs, masks, params):
        idx = params["index"]
        if self.sigma_limit[1] <= 0:
            table = torch.as_tensor(np.stack(
                [self._sigma0_row(s)
                 for s in range(self.kmin, self.kmax + 1, 2)]),
                device=imgs.device)
            g = table[idx]
            kernel = g[:, :, None] * g[:, None, :]
        else:
            r = idx[:, None] + (self.kmin - 1) // 2  # (size - 1) / 2
            taps = torch.arange(self.kmax, device=imgs.device) - self.kmax // 2
            xs = taps.to(torch.float32)[None]
            g = torch.where(taps.abs()[None] <= r, torch.exp(
                -0.5 * (xs / params["sigma"][:, None]) ** 2),
                torch.zeros_like(xs))
            kernel = g[:, :, None] * g[:, None, :]
            kernel = kernel / kernel.sum(dim=(1, 2), keepdim=True)
        return _depthwise_blur(imgs, kernel), masks


class MotionBlur(Transform):
    """A line kernel at a random angle (albumentations MotionBlur) with the
    ``direction`` ramp (weight 1 + direction·t along the line, t in
    [-1, 1]) and, with ``allow_shifted``, the line's centre offset within
    the grid while the whole line stays inside."""

    def __init__(self, blur_limit=(3, 7), allow_shifted: bool = True,
                 direction_range=(-1.0, 1.0), p: float = 0.5, **kw):
        super().__init__(p=p)
        self.kmin, self.kmax = _odd_sizes(blur_limit)
        self.allow_shifted = bool(allow_shifted)
        self.direction_range = tuple(direction_range)

    def sample(self, generator, n, shape):
        return {"size": self.kmin + 2 * _size_index(generator, n, self.kmin,
                                                    self.kmax),
                "angle": _uniform(generator, n, 0.0, math.pi),
                "direction": _uniform(generator, n, *self.direction_range),
                "shift": -1.0 + 2.0 * _rand(generator, n, 2)}

    def kernel(self, params):
        angle = params["angle"][:, None, None]
        r = ((params["size"] - 1) / 2.0)[:, None, None]
        c = self.kmax // 2
        cy = cx = torch.full_like(angle, float(c))
        if self.allow_shifted:
            my = torch.clamp_min(c - r * angle.sin().abs(), 0.0)
            mx = torch.clamp_min(c - r * angle.cos().abs(), 0.0)
            shift = params["shift"][:, :, None, None]
            cy, cx = cy + shift[:, 0] * my, cx + shift[:, 1] * mx
        grid = torch.arange(self.kmax, device=angle.device)
        yy = grid[None, :, None] - cy
        xx = grid[None, None, :] - cx
        d_perp = (-angle.sin() * xx + angle.cos() * yy).abs()
        t = angle.cos() * xx + angle.sin() * yy
        on_line = (d_perp <= 0.5) & (t.abs() <= r)
        ramp = torch.clamp_min(1.0 + params["direction"][:, None, None] * t
                               / torch.clamp_min(r, 1.0), 0.0)
        kernel = torch.where(on_line, ramp, torch.zeros_like(ramp))
        return kernel / torch.clamp_min(kernel.sum(dim=(1, 2), keepdim=True),
                                        1e-6)

    def apply(self, imgs, masks, params):
        return _depthwise_blur(imgs, self.kernel(params)), masks


class Defocus(Transform):
    """A disk kernel smoothed by a small gaussian (albumentations
    Defocus)."""

    def __init__(self, radius=(3, 10), alias_blur=(0.1, 0.5), p: float = 0.5,
                 **kw):
        super().__init__(p=p)
        self.radius = ((radius, radius) if isinstance(radius, int)
                       else tuple(radius))
        self.alias_blur = tuple(alias_blur)
        self.kmax = 2 * int(self.radius[1]) + 1

    def sample(self, generator, n, shape):
        return {"radius": _randint(generator, self.radius[0],
                                   self.radius[1] + 1, n),
                "alias_blur": _uniform(generator, n, *self.alias_blur)}

    def kernel(self, params):
        r = params["radius"][:, None, None]
        grid = torch.arange(self.kmax, device=r.device) - self.kmax // 2
        disk = (grid[None, :, None] ** 2 + grid[None, None, :] ** 2
                <= r ** 2).to(torch.float32)
        xs = (torch.arange(5, device=r.device) - 2).to(torch.float32)
        sigma = torch.clamp_min(params["alias_blur"], 1e-3)[:, None]
        g = torch.exp(-0.5 * (xs[None] / sigma) ** 2)
        g2 = g[:, :, None] * g[:, None, :]
        g2 = g2 / g2.sum(dim=(1, 2), keepdim=True)
        disk = _depthwise_blur(disk[:, None], g2)[:, 0]
        return disk / torch.clamp_min(disk.sum(dim=(1, 2), keepdim=True),
                                      1e-6)

    def apply(self, imgs, masks, params):
        return _depthwise_blur(imgs, self.kernel(params)), masks


class GlassBlur(Transform):
    """imagecorruptions-style glass blur: a gaussian(sigma), ``iterations``
    rounds of per-pixel displacement within ``max_delta`` (in [-d, d), as
    ``np.random.randint``), then the gaussian again.  The gaussian is
    separable with scipy's truncate 4 (radius ``int(4 sigma + 0.5)``); the
    displacement is one gather with clamped indices, a parallel version of
    albumentations' sequential swaps."""

    def __init__(self, sigma: float = 0.7, max_delta: int = 4,
                 iterations: int = 2, p: float = 0.5, mode: str = "fast",
                 **kw):
        super().__init__(p=p)
        self.sigma = sigma
        self.max_delta = int(max_delta)
        self.iterations = int(iterations)

    def _gauss_kernel(self, device):
        r = max(int(4.0 * self.sigma + 0.5), 1)
        xs = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
        g = torch.exp(-0.5 * (xs / self.sigma) ** 2)
        return g / g.sum()

    def _blur(self, imgs):
        g = self._gauss_kernel(imgs.device)
        return _depthwise_blur(_depthwise_blur(imgs, g[:, None]), g[None, :])

    def sample(self, generator, n, shape):
        _, h, w = shape
        d = self.max_delta
        return {"dy": _randint(generator, -d, d, n, self.iterations, h, w),
                "dx": _randint(generator, -d, d, n, self.iterations, h, w)}

    def apply(self, imgs, masks, params):
        n, _, h, w = imgs.shape
        out = self._blur(imgs)
        rows = torch.arange(h, device=imgs.device)[None, :, None]
        cols = torch.arange(w, device=imgs.device)[None, None, :]
        for i in range(self.iterations):
            out = _taps(out, rows + params["dy"][:, i],
                        cols + params["dx"][:, i], 1, 0.0)
        return self._blur(out), masks


# ----------------------------------------------------------------- colour

class RandomBrightnessContrast(Transform):

    def __init__(self, brightness_limit=(-0.2, 0.2),
                 contrast_limit=(-0.2, 0.2), brightness_by_max: bool = True,
                 p: float = 0.5, **kw):
        super().__init__(p=p)
        self.brightness_limit = tuple(brightness_limit) if isinstance(
            brightness_limit, (list, tuple)) else (-brightness_limit,
                                                   brightness_limit)
        self.contrast_limit = tuple(contrast_limit) if isinstance(
            contrast_limit, (list, tuple)) else (-contrast_limit,
                                                 contrast_limit)
        self.brightness_by_max = brightness_by_max

    def sample(self, generator, n, shape):
        return {"alpha": 1.0 + _uniform(generator, n, *self.contrast_limit),
                "beta": _uniform(generator, n, *self.brightness_limit)}

    def apply(self, imgs, masks, params):
        alpha = params["alpha"][:, None, None, None]
        beta = params["beta"][:, None, None, None]
        # albumentations' uint8 table uses the ORIGINAL image's mean when
        # brightness_by_max is off
        mean = imgs.mean(dim=(1, 2, 3), keepdim=True)
        out = imgs * alpha
        out = out + (beta * 255.0 if self.brightness_by_max else beta * mean)
        return out.clamp(0.0, 255.0), masks


class RandomGamma(Transform):

    def __init__(self, gamma_limit=(80, 120), p: float = 0.5, **kw):
        super().__init__(p=p)
        self.gamma_limit = tuple(gamma_limit)

    def sample(self, generator, n, shape):
        return {"gamma": _uniform(generator, n, *self.gamma_limit) / 100.0}

    def apply(self, imgs, masks, params):
        gamma = params["gamma"][:, None, None, None]
        out = 255.0 * torch.clamp_min(imgs / 255.0, 1e-8) ** gamma
        return out.clamp(0.0, 255.0), masks


def _hue(img, mx, d):
    """Hue in degrees of ``(N, 3, H, W)`` in [0, 1] (the same in HSV and
    HLS); ``%`` is a floor modulo, as ``jnp``'s."""
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    safe_d = torch.clamp_min(d, 1e-8)
    h = torch.where(mx == r, torch.remainder((g - b) / safe_d, 6.0),
                    torch.where(mx == g, (b - r) / safe_d + 2.0,
                                (r - g) / safe_d + 4.0))
    return torch.where(d == 0, torch.zeros_like(h), h) * 60.0


def _rgb_to_hsv(img):
    """(N, 3, H, W) RGB in [0, 1] -> (N, 3, H, W) HSV, H in degrees."""
    mx = img.amax(dim=1)
    d = mx - img.amin(dim=1)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.clamp_min(mx, 1e-8))
    return torch.stack([_hue(img, mx, d), s, mx], dim=1)


def _sector_to_rgb(h, c, x, m):
    """The RGB of hue sector ``floor(h) % 6`` with chroma ``c`` and second
    component ``x``, plus ``m``."""
    idx = torch.remainder(torch.floor(h).to(torch.int32), 6)
    z = torch.zeros_like(c)
    table = ((c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c),
             (c, z, x))
    rgb = [z, z, z]
    for k in reversed(range(6)):  # the first matching sector wins
        rgb = [torch.where(idx == k, v, old) for v, old in zip(table[k], rgb)]
    return torch.stack([v + m for v in rgb], dim=1)


def _hsv_to_rgb(hsv):
    """(N, 3, H, W) HSV (H in degrees) -> RGB."""
    h = torch.remainder(hsv[:, 0], 360.0) / 60.0
    s, v = hsv[:, 1], hsv[:, 2]
    c = v * s
    x = c * (1 - (torch.remainder(h, 2) - 1).abs())
    return _sector_to_rgb(h, c, x, v - c)


class HueSaturationValue(Transform):

    def __init__(self, hue_shift_limit=(-20, 20), sat_shift_limit=(-30, 30),
                 val_shift_limit=(-20, 20), p: float = 0.5, **kw):
        super().__init__(p=p)

        def _pair(v):
            return tuple(v) if isinstance(v, (list, tuple)) else (-v, v)
        self.hue_shift_limit = _pair(hue_shift_limit)
        self.sat_shift_limit = _pair(sat_shift_limit)
        self.val_shift_limit = _pair(val_shift_limit)

    def sample(self, generator, n, shape):
        return {"hue": _uniform(generator, n, *self.hue_shift_limit),
                "sat": _uniform(generator, n, *self.sat_shift_limit),
                "val": _uniform(generator, n, *self.val_shift_limit)}

    def apply(self, imgs, masks, params):
        hsv = _rgb_to_hsv(imgs / 255.0)
        shift = {k: v[:, None, None] for k, v in params.items()}
        # cv2's hue unit is 2 degrees
        h = torch.remainder(hsv[:, 0] + shift["hue"] * 2.0, 360.0)
        s = (hsv[:, 1] + shift["sat"] / 255.0).clamp(0.0, 1.0)
        v = (hsv[:, 2] + shift["val"] / 255.0).clamp(0.0, 1.0)
        out = _hsv_to_rgb(torch.stack([h, s, v], dim=1)) * 255.0
        return out.clamp(0.0, 255.0), masks


def _rgb_to_hls(img):
    """(N, 3, H, W) RGB in [0, 1] -> (N, 3, H, W) HLS, H in degrees."""
    mx = img.amax(dim=1)
    mn = img.amin(dim=1)
    d = mx - mn
    light = (mx + mn) / 2.0
    denom = 1.0 - (2.0 * light - 1.0).abs()
    s = torch.where(d == 0, torch.zeros_like(d),
                    d / torch.clamp_min(denom, 1e-8))
    return torch.stack([_hue(img, mx, d), light, s], dim=1)


def _hls_to_rgb(hls):
    """(N, 3, H, W) HLS (H in degrees) -> RGB."""
    h = torch.remainder(hls[:, 0], 360.0) / 60.0
    light, s = hls[:, 1], hls[:, 2]
    c = (1.0 - (2.0 * light - 1.0).abs()) * s
    x = c * (1 - (torch.remainder(h, 2) - 1).abs())
    return _sector_to_rgb(h, c, x, light - c / 2.0)


class ISONoise(Transform):
    """Camera sensor noise (albumentations iso_noise): Poisson noise of
    lambda = std(HLS lightness)·intensity·255, drawn as Normal(lambda,
    sqrt(lambda)) clipped at 0, added to the lightness scaled by (1 - L),
    and a gaussian hue shift of std color_shift·intensity·360 degrees.
    The std is the population std, as ``jnp.std``'s."""

    def __init__(self, color_shift=(0.01, 0.05), intensity=(0.1, 0.5),
                 p: float = 0.5, **kw):
        super().__init__(p=p)
        self.color_shift = tuple(color_shift)
        self.intensity = tuple(intensity)

    def sample(self, generator, n, shape):
        _, h, w = shape
        normal = torch.randn((2, n, h, w), generator=generator,
                             device=generator.device)
        return {"intensity": _uniform(generator, n, *self.intensity),
                "color_shift": _uniform(generator, n, *self.color_shift),
                "lum_normal": normal[0], "hue_normal": normal[1]}

    def apply(self, imgs, masks, params):
        intensity = params["intensity"][:, None, None]
        hls = _rgb_to_hls(imgs / 255.0)
        light = hls[:, 1]
        lam = light.std(dim=(1, 2), correction=0, keepdim=True) \
            * intensity * 255.0
        lum_noise = torch.clamp_min(
            lam + torch.sqrt(torch.clamp_min(lam, 0.0))
            * params["lum_normal"], 0.0)
        hue_noise = (params["hue_normal"]
                     * params["color_shift"][:, None, None] * intensity
                     * 360.0)
        h = torch.remainder(hls[:, 0] + hue_noise, 360.0)
        light = (light + (lum_noise / 255.0) * (1.0 - light)).clamp(0.0, 1.0)
        out = _hls_to_rgb(torch.stack([h, light, hls[:, 2]], dim=1))
        return (out * 255.0).clamp(0.0, 255.0), masks


class Normalize(Transform):

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 max_pixel_value: float = 255.0, p: float = 1.0, **kw):
        super().__init__(p=p)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.max_pixel_value = max_pixel_value

    def apply(self, imgs, masks, params):
        mean = torch.as_tensor(self.mean, device=imgs.device) \
            * self.max_pixel_value
        std = torch.as_tensor(self.std, device=imgs.device) \
            * self.max_pixel_value
        return (imgs - mean[:, None, None]) / std[:, None, None], masks


class ToTensorV2(Transform):
    """A layout no-op: the port is NCHW already."""

    def __init__(self, p: float = 1.0, transpose_mask: bool = False, **kw):
        super().__init__(p=p)

    def apply(self, imgs, masks, params):
        return imgs, masks

    def __call__(self, generator, imgs, masks):
        return imgs, masks


TRANSFORMS: Dict[str, Any] = {
    "Compose": Compose,
    "OneOf": OneOf,
    "Resize": Resize,
    "Rotate": Rotate,
    "HorizontalFlip": HorizontalFlip,
    "VerticalFlip": VerticalFlip,
    "RandomCrop": RandomCrop,
    "PadIfNeeded": PadIfNeeded,
    "Blur": Blur,
    "GaussianBlur": GaussianBlur,
    "MotionBlur": MotionBlur,
    "Defocus": Defocus,
    "GlassBlur": GlassBlur,
    "RandomBrightnessContrast": RandomBrightnessContrast,
    "RandomGamma": RandomGamma,
    "HueSaturationValue": HueSaturationValue,
    "ISONoise": ISONoise,
    "Normalize": Normalize,
    "ToTensorV2": ToTensorV2,
}
