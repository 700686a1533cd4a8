"""LightHamHead, SegNeXt's decode head (counterpart of
``models/decode_heads/ham_head.py``).

The selected levels are resized to the first one's size and concatenated,
squeezed by a 1 x 1 ConvModule, passed through the ``Hamburger`` (1 x 1
conv, ReLU, ``NMF2D``, 1 x 1 conv with GroupNorm, plus the input, ReLU),
aligned by a 1 x 1 ConvModule and classified.

``NMF2D`` factorises the ``(B, D, N)`` spatial matrix (``B`` = batch x
``MD_S``, ``D`` = channels / ``MD_S``, ``N`` = pixels) with ``MD_R``
random bases, L2-normalised over ``D``: the coefficients start as a
softmax of ``INV_T`` times the projections, then ``TRAIN_STEPS`` (training)
or ``EVAL_STEPS`` multiplicative updates of coefficients and bases run
without grad, and one last coefficient step with bases and coefficients
detached carries the gradient to the input, as the JAX package's
``stop_gradient`` does; the output is ``bases @ coefᵀ``.  The products are
``torch.bmm`` in float32 outside autocast (float64 for a float64 input),
and the result is cast back to the input's dtype.

The bases are ``uniform(0, 1)`` draws from ``draw_bases``, a module
function looked up at call time (tests hand in the JAX draw through it): in
training from the generator ``models.basic.drop.use_generator`` installs
(the train step's), which raises without one; at eval from a generator
seeded with 0 on the input's device, so one input gives the same bits on
every call.  The JAX package draws from its ``'nmf'``/``'dropout'`` stream
and from ``PRNGKey(0)``: the bits differ.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..basic.drop import current_generator
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead

_EPS = 1e-6


def draw_bases(shape, device, dtype, training: bool):
    """``uniform(0, 1)`` bases of ``shape`` (see the module docstring)."""
    if training:
        generator = current_generator()
        if generator is None:
            raise RuntimeError("NMF2D in training draws its bases from a "
                               "generator: run the forward under "
                               "models.basic.drop.use_generator(g)")
    else:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=generator, device=device, dtype=dtype)


def _coef_step(x, bases, coef):
    """One multiplicative coefficient update; ``x (B, D, N)``, ``bases (B,
    D, R)``, ``coef (B, N, R)``."""
    numerator = torch.bmm(x.transpose(1, 2), bases)
    denominator = torch.bmm(coef, torch.bmm(bases.transpose(1, 2), bases))
    return coef * numerator / (denominator + _EPS)


def _bases_step(x, bases, coef):
    numerator = torch.bmm(x, coef)
    denominator = torch.bmm(bases, torch.bmm(coef.transpose(1, 2), coef))
    return bases * numerator / (denominator + _EPS)


class NMF2D(nn.Module):
    """``ham_kwargs``: ``MD_S``, ``MD_R``, ``TRAIN_STEPS``, ``EVAL_STEPS``,
    ``INV_T``, ``RAND_INIT`` (``SPATIAL=True`` and random bases only, as
    every config uses)."""

    def __init__(self, ham_kwargs: Optional[Dict] = None):
        super().__init__()
        kw = dict(ham_kwargs or {})
        assert kw.pop("SPATIAL", True), "only SPATIAL=True is supported"
        self.S = kw.pop("MD_S", 1)
        self.R = kw.pop("MD_R", 64)
        self.train_steps = kw.pop("TRAIN_STEPS", 6)
        self.eval_steps = kw.pop("EVAL_STEPS", 7)
        self.inv_t = kw.pop("INV_T", 100)
        kw.pop("ETA", None)
        kw.pop("MD_D", None)
        assert kw.pop("RAND_INIT", True), \
            "online (RAND_INIT=False) bases are not supported"
        assert not kw, f"unknown ham_kwargs {sorted(kw)}"

    def forward(self, x):
        n, c, h, w = x.shape
        B, D = n * self.S, c // self.S
        dtype = torch.promote_types(x.dtype, torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            xm = x.reshape(B, D, h * w).to(dtype)
            bases = draw_bases((B, D, self.R), x.device, dtype,
                               self.training)
            bases = bases / (torch.linalg.vector_norm(bases, dim=1,
                                                      keepdim=True) + 1e-12)
            with torch.no_grad():
                coef = torch.softmax(
                    self.inv_t * torch.bmm(xm.transpose(1, 2), bases), -1)
                for _ in range(self.train_steps if self.training
                               else self.eval_steps):
                    coef = _coef_step(xm, bases, coef)
                    bases = _bases_step(xm, bases, coef)
            coef = _coef_step(xm, bases, coef)
            out = torch.bmm(bases, coef.transpose(1, 2))
        return out.reshape(n, c, h, w).to(x.dtype)


class Hamburger(nn.Module):
    """ham_in -> ReLU -> NMF2D -> ham_out, plus the input, ReLU."""

    def __init__(self, ham_channels: int, ham_kwargs: Optional[Dict] = None,
                 norm_cfg: Optional[Dict] = None):
        super().__init__()
        self.ham_in = ConvModule(ham_channels, ham_channels, 1,
                                 norm_cfg=None, act_cfg=None)
        self.ham = NMF2D(ham_kwargs)
        self.ham_out = ConvModule(ham_channels, ham_channels, 1,
                                  norm_cfg=norm_cfg, act_cfg=None)

    def forward(self, x):
        enjoy = self.ham_out(self.ham(F.relu(self.ham_in(x))))
        return F.relu(x + enjoy)


@DECODEHEAD.register()
class LightHamHead(BaseDecodeHead):
    """``input_transform='multiple_select'``: squeeze -> Hamburger ->
    align -> classify."""

    def __init__(self, in_channels, channels: int, *,
                 ham_channels: int = 512, ham_kwargs: Optional[Dict] = None,
                 **kwargs):
        super().__init__(in_channels, channels, **kwargs)
        assert self.input_transform == "multiple_select"
        self.squeeze = ConvModule(sum(in_channels), ham_channels, 1,
                                  conv_cfg=self.conv_cfg,
                                  norm_cfg=self.norm_cfg,
                                  act_cfg=self.act_cfg)
        self.hamburger = Hamburger(ham_channels, ham_kwargs,
                                   norm_cfg=self.norm_cfg)
        self.align = ConvModule(ham_channels, channels, 1,
                                conv_cfg=self.conv_cfg,
                                norm_cfg=self.norm_cfg,
                                act_cfg=self.act_cfg)

    def forward(self, inputs):
        feats = self._transform_inputs(inputs)
        feats = [feats[0]] + [
            resize(f, size=feats[0].shape[2:], mode="bilinear",
                   align_corners=self.align_corners) for f in feats[1:]]
        x = self.hamburger(self.squeeze(torch.cat(feats, dim=1)))
        return self.cls_seg(self.align(x))
