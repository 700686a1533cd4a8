"""DDRHead, the two-logit head of DDRNet (counterpart of
``models/decode_heads/ddr_head.py``).

It takes the backbone's ``(spatial tap, merged)`` pair.  At eval only the
merged features run through ``context_head``; in training the spatial
tap (half the merged width) gets ``spatial_head``, and both logit maps are
resized to the label for ``loss_decode[0]`` (``loss_context``) and
``loss_decode[1]`` (``loss_spatial``).  The blocks are PIDHead's
``_BasePIDHead``; the head has no ``conv_seg``.
"""

from __future__ import annotations

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..losses import accuracy
from .decode_head import BaseDecodeHead
from .pid_head import _BasePIDHead, rescaled


@DECODEHEAD.register()
class DDRHead(BaseDecodeHead):
    """``in_channels``: the merged width (4C); the spatial tap is
    ``in_channels // 2`` wide."""

    def __init__(self, in_channels: int, channels: int, **kwargs):
        super().__init__(in_channels, channels, **kwargs)
        assert len(self.losses_decode) == 2, (
            "DDRHead needs loss_decode=[context, spatial], got "
            f"{len(self.losses_decode)}")
        del self.conv_seg
        ncfg = dict(self.norm_cfg or dict(type="BN"))
        out_ch = self.resolved_out_channels()
        self.context_head = _BasePIDHead(in_channels, channels, out_ch, ncfg)
        self.spatial_head = _BasePIDHead(in_channels // 2, channels, out_ch,
                                         ncfg)

    def init_weights(self, generator):
        pass  # the classifiers are the blocks' own

    def forward(self, inputs):
        x = inputs[-1] if isinstance(inputs, (list, tuple)) else inputs
        return self.context_head(x)

    def forward_train(self, inputs, gt_semantic_seg, meta_infos=None,
                      rescale: bool = False):
        assert isinstance(inputs, (list, tuple)) and len(inputs) == 2, (
            "DDRHead expects the DDRNet (spatial tap, merged) pair")
        c3_feat, c5_feat = inputs
        label = gt_semantic_seg
        up = dict(size=label.shape[1:], mode="bilinear",
                  align_corners=self.align_corners)
        logit_c = resize(self.context_head(c5_feat), **up)
        logit_s = resize(self.spatial_head(c3_feat), **up)
        ctx_loss, sp_loss = self.losses_decode
        loss = dict(
            loss_context=ctx_loss(logit_c, label,
                                  ignore_index=self.ignore_index),
            loss_spatial=sp_loss(logit_s, label,
                                 ignore_index=self.ignore_index),
            acc_seg=accuracy(logit_c, label, ignore_index=self.ignore_index))
        return rescaled(logit_c, meta_infos, rescale,
                        self.align_corners), loss
