"""PSAHead, point-wise spatial attention (counterpart of
``models/decode_heads/psa_head.py``; Zhao et al., ECCV 2018).

``psa_mask`` is mmcv's ``PSAMask`` as a gather: pixel ``a``'s
``(mask_h x mask_w)`` attention plane gives pixel ``b`` its tap at the
offset ``b - a + half``, or 0 where that offset leaves the mask.  The
``(L, L)`` tap index and validity tables are made on the device, once per
geometry and device.  ``collect`` keeps the ``(a, b)`` layout,
``distribute`` transposes it.  The gather is ``torch.gather``, whose
backward (a ``scatter_add``) has a deterministic implementation under
``torch.use_deterministic_algorithms(True)``.

The head (``bi-direction``, or one of the two): ``reduce`` (1x1), the
shrink (a bilinear resize by ``shrink_factor``; the JAX package's quirk:
when both sides are odd they become ``(n - 1) // sf + 1`` and
``align_corners`` turns True, for this resize and the one back), the
attention stack (a 1x1 ConvModule, a bias-free 1x1 conv to ``mask_h *
mask_w`` channels), the mask (the JAX head's ``compact`` planes, which no
config selects, are not ported yet and raise), a float32 softmax over the
keys cast to the map's dtype, the float32 aggregation with the shrunk map
(``ops/attention.float32_product``) cast back and divided by
``normalization_factor``; then ``proj`` back to ``in_channels``, the
resize to the input's size, a 3x3 ``bottleneck`` over ``[input, proj]``,
``cls_seg``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...ops.attention import float32_product
from ...utils.ops import resize
from ..basic.convolution import Conv2d
from ..common.conv_module import ConvModule
from .decode_head import BaseDecodeHead


@functools.lru_cache(maxsize=16)
def mask_tables(h: int, w: int, mask_size: Tuple[int, int], device):
    """``(idx, valid)``, each ``(L, L)``: row ``a``, column ``b`` hold the
    tap of ``b`` in ``a``'s plane (clipped into the mask) and whether it
    lies inside."""
    mask_h, mask_w = mask_size
    pos = torch.arange(h * w, device=device)
    ai, aj = pos // w, pos % w
    dh = ai[None, :] - ai[:, None] + (mask_h - 1) // 2
    dw = aj[None, :] - aj[:, None] + (mask_w - 1) // 2
    valid = (dh >= 0) & (dh < mask_h) & (dw >= 0) & (dw < mask_w)
    idx = dh.clamp(0, mask_h - 1) * mask_w + dw.clamp(0, mask_w - 1)
    return idx, valid


def psa_mask(x, mask_size: Tuple[int, int], psa_type: str):
    """``x (N, mask_h * mask_w, h, w)`` -> ``(N, L, L)``: collect's ``[n, a,
    b]``, or distribute's transpose."""
    n, m, h, w = x.shape
    assert m == mask_size[0] * mask_size[1], (m, mask_size)
    idx, valid = mask_tables(h, w, tuple(mask_size), x.device)
    planes = x.flatten(2).transpose(1, 2)                         # (N, L, M)
    g = planes.gather(2, idx.expand(n, -1, -1))
    g = torch.where(valid, g, g.new_zeros(()))
    return g.transpose(1, 2) if psa_type == "distribute" else g


@DECODEHEAD.register()
class PSAHead(BaseDecodeHead):

    def __init__(self, mask_size: Tuple[int, int] = (97, 97),
                 psa_type: str = "bi-direction", compact: bool = False,
                 shrink_factor: int = 2, normalization_factor: float = 1.0,
                 psa_softmax: bool = True, **kwargs):
        super().__init__(**kwargs)
        assert psa_type in ("collect", "distribute", "bi-direction")
        if compact:
            raise NotImplementedError("PSAHead compact=True is not ported "
                                      "yet (ROADMAP.md Queue 1 item 8)")
        self.mask_size = tuple(mask_size)
        self.psa_type = psa_type
        self.shrink_factor = shrink_factor
        self.normalization_factor = normalization_factor
        self.psa_softmax = psa_softmax
        common = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                      act_cfg=self.act_cfg)
        ch, taps = self.channels, self.mask_size[0] * self.mask_size[1]

        def attention():
            return nn.ModuleList([ConvModule(ch, ch, 1, **common),
                                  Conv2d(ch, taps, 1, bias=False)])

        self.reduce = ConvModule(self.fused_in_channels, ch, 1, **common)
        self.attention = attention()
        if psa_type == "bi-direction":
            self.reduce_p = ConvModule(self.fused_in_channels, ch, 1,
                                       **common)
            self.attention_p = attention()
        self.proj = ConvModule(ch * (2 if psa_type == "bi-direction" else 1),
                               self.fused_in_channels, 1, **common)
        self.bottleneck = ConvModule(self.fused_in_channels * 2, ch, 3,
                                     padding=1, **common)

    def _shrink(self, out, align_corners):
        h, w = out.shape[2:]
        sf = self.shrink_factor
        if sf == 1:
            return out, align_corners
        if h % sf and w % sf:
            size, align_corners = ((h - 1) // sf + 1, (w - 1) // sf + 1), True
        else:
            size, align_corners = (h // sf, w // sf), False
        return resize(out, size=size, mode="bilinear",
                      align_corners=align_corners), align_corners

    def _attend(self, feat, attention, psa_type):
        n, c, h, w = feat.shape
        y = psa_mask(attention[1](attention[0](feat)), self.mask_size,
                     psa_type)
        if self.psa_softmax:
            acc = torch.promote_types(y.dtype, torch.float32)
            y = torch.softmax(y.to(acc), dim=-1).to(feat.dtype)
        out = float32_product(y, feat.flatten(2).transpose(1, 2))
        out = out.to(feat.dtype) * (1.0 / self.normalization_factor)
        return out.transpose(1, 2).reshape(n, c, h, w)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)
        align_corners = self.align_corners
        if self.psa_type in ("collect", "distribute"):
            out, align_corners = self._shrink(self.reduce(x), align_corners)
            out = self._attend(out, self.attention, self.psa_type)
        else:
            x_col, align_corners = self._shrink(self.reduce(x),
                                                align_corners)
            x_dis, _ = self._shrink(self.reduce_p(x), align_corners)
            out = torch.cat([
                self._attend(x_col, self.attention, "collect"),
                self._attend(x_dis, self.attention_p, "distribute")],
                dim=1)
        out = resize(self.proj(out), size=x.shape[2:], mode="bilinear",
                     align_corners=align_corners)
        return self.cls_seg(self.bottleneck(torch.cat([x, out], dim=1)))
