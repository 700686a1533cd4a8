"""Segmenter's mask-transformer decode head (counterpart of
``models/decode_heads/segmenter_mask_head.py``).

The patch tokens (``proj_dec``, a ``Linear``) and K learned class
embeddings (``cls_emb``, appended after them) pass ``num_layers`` of the
port's ``ViTBlock`` (so on a CUDA tensor the attention runs the flash
kernels over L + K tokens) and ``decoder_norm``; patches and classes are
then multiplied by the raw ``(C, C)`` matrices ``proj_patch`` and
``proj_classes`` (``x @ P``: parameters, not ``nn.Linear``, so the bridge
copies them as they are), L2-normalised in float32 (float64 for float64),
and their products are the masks, ``(N, L, K)``, layer-normalised over K
(``mask_norm``) and returned as ``(N, K, H, W)`` in float32 (float64).

The similarity is the classifier: the head has no ``conv_seg``, as the JAX
head creates none.  Init (``init_weights``): truncated normal (std 0.02)
for ``proj_dec``'s weight, ``cls_emb`` and the decoder's linear weights
with zero biases, normal (std C^-1/2) for ``proj_patch`` and
``proj_classes``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ..backbones.vit import ViTBlock
from ..basic.convolution import Linear
from ..basic.normalization import LayerNorm
from .decode_head import BaseDecodeHead


@DECODEHEAD.register()
class SegmenterMaskTransformerHead(BaseDecodeHead):

    def __init__(self, num_layers: int = 2, num_heads: int = 6,
                 mlp_ratio: int = 4, qkv_bias: bool = True,
                 drop_path_rate: float = 0.1, attn_drop_rate: float = 0.0,
                 **kwargs):
        super().__init__(**kwargs)
        del self.conv_seg
        C = self.channels
        K = self.resolved_out_channels()
        self.proj_dec = Linear(self.fused_in_channels, C)
        self.cls_emb = nn.Parameter(torch.zeros(1, K, C))
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", ViTBlock(
                C, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                drop_rate=self.dropout.p if self.dropout else 0.0,
                attn_drop_rate=attn_drop_rate,
                drop_path_rate=drop_path_rate * i / max(num_layers - 1, 1)))
        self.decoder_norm = LayerNorm(C)
        self.proj_patch = nn.Parameter(torch.zeros(C, C))
        self.proj_classes = nn.Parameter(torch.zeros(C, C))
        self.mask_norm = LayerNorm(K)

    def init_weights(self, generator):
        linears = [self.proj_dec] + [
            m for i in range(self.num_layers)
            for m in getattr(self, f"layer{i}").modules()
            if isinstance(m, nn.Linear)]
        for w in (self.cls_emb, *(m.weight for m in linears)):
            nn.init.trunc_normal_(w, std=0.02, generator=generator)
        for m in linears[1:]:
            nn.init.zeros_(m.bias)
        for w in (self.proj_patch, self.proj_classes):
            nn.init.normal_(w, 0.0, self.channels ** -0.5,
                            generator=generator)

    def forward(self, inputs):
        x = self._transform_inputs(inputs)            # (N, C_in, H, W)
        N, _, H, W = x.shape
        K = self.cls_emb.shape[1]
        x = self.proj_dec(x.flatten(2).transpose(1, 2))
        x = torch.cat([x, self.cls_emb.to(x.dtype).expand(N, -1, -1)],
                      dim=1)                          # (N, L + K, C)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        x = self.decoder_norm(x)
        patches = x[:, :-K] @ self.proj_patch.to(x.dtype)
        classes = x[:, -K:] @ self.proj_classes.to(x.dtype)
        acc = torch.promote_types(x.dtype, torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            patches, classes = patches.to(acc), classes.to(acc)
            patches = patches / torch.linalg.vector_norm(patches, dim=-1,
                                                         keepdim=True)
            classes = classes / torch.linalg.vector_norm(classes, dim=-1,
                                                         keepdim=True)
            masks = self.mask_norm(torch.einsum("nlc,nkc->nlk", patches,
                                                classes))
        return masks.transpose(1, 2).reshape(N, K, H, W)
