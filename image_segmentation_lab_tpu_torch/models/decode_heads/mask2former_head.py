"""Mask2Former head (counterpart of ``models/decode_heads/mask2former_head.py``).

Built on the MaskFormer head (its matcher, losses and combination), with
Mask2Former's three changes:

* masked cross-attention: each decoder layer attends only inside the
  foreground (sigmoid > 0.5) of its query's previous mask, a boolean map
  on the float32 scores (``ops/attention.biased_attention``); a row that
  would block every key attends to all.  Cross-attention comes before
  self-attention;
* a round-robin memory over the three coarsest pixel-decoder levels (1/32,
  1/16, 1/8), each with its own sinusoidal position encoding plus a
  learned level embedding;
* learned query features: the decoder starts from ``query_feat``, and a
  prediction made from them before the first layer is supervised like
  the rest.

As in the JAX head, the blocked map at a level comes from the mask
features resized once per level (bilinear resizing commutes with the
channel product, so this is upstream's per-layer resize of the mask
logits), and the pixel decoder is the FPN one rather than upstream's
deformable-attention encoder.  The blocked maps take no gradient (a
comparison): they are computed without grad, so the level resizes are
plain ``F.interpolate`` calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...utils.ops import resize
from ..basic.convolution import Linear
from ..basic.normalization import LayerNorm
from .maskformer_head import (CrossAttention, MaskFormerHead, map_tokens,
                              position_tokens)


class Mask2FormerDecoderLayer(nn.Module):
    """Post-norm, cross-attention-first decoder layer."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int):
        super().__init__()
        self.cross_attn = CrossAttention(embed_dims, num_heads)
        self.norm1 = LayerNorm(embed_dims)
        self.self_attn = CrossAttention(embed_dims, num_heads)
        self.norm2 = LayerNorm(embed_dims)
        self.ffn_fc1 = Linear(embed_dims, feedforward_channels)
        self.ffn_fc2 = Linear(feedforward_channels, embed_dims)
        self.norm3 = LayerNorm(embed_dims)

    def forward(self, x, memory, query_pos, mem_pos, blocked):
        y = self.cross_attn(x + query_pos, memory + mem_pos, memory,
                            blocked=blocked)
        x = self.norm1(x + y)
        y = self.self_attn(x + query_pos, x + query_pos, x)
        x = self.norm2(x + y)
        y = self.ffn_fc2(F.relu(self.ffn_fc1(x)))
        return self.norm3(x + y)


@DECODEHEAD.register()
class Mask2FormerHead(MaskFormerHead):

    _uses_raw_memory = False  # the memory is the pixel decoder's levels

    def __init__(self, in_channels, channels, *, num_scales: int = 3,
                 mask_attn_threshold: float = 0.5, **kwargs):
        super().__init__(in_channels, channels, **kwargs)
        self.num_scales = num_scales
        self.mask_attn_threshold = mask_attn_threshold
        assert self.feat_channels == channels, \
            "Mask2Former's memory is the pixel decoder's: feat_channels " \
            "must equal channels"
        self.query_feat = nn.Parameter(torch.zeros(self.num_queries,
                                                   channels))
        self.level_embed = nn.Parameter(torch.zeros(num_scales, channels))

    def _make_decoder_layer(self):
        return Mask2FormerDecoderLayer(self.channels, self.num_heads,
                                       self.feedforward_channels)

    def _embedding_params(self):
        return [self.query_embed, self.query_feat, self.level_embed]

    def _embed(self, x):
        """Query features -> (cls logits, mask embeddings)."""
        x = self.decoder_norm(x)
        return self.cls_embed(x), self._mask_embedding(x)

    def _attn_blocked(self, emb, level_mask_feat):
        """(N, Q, h·w) bool: the keys outside each query's foreground at the
        level's resolution, from the mask embeddings (N, Q, C) and the
        level-resized mask features (N, C, h, w)."""
        with torch.no_grad():
            m = self._mask_logits(emb.detach(), level_mask_feat)
            acc = torch.promote_types(m.dtype, torch.float32)
            blocked = torch.sigmoid(m.to(acc)) < self.mask_attn_threshold
        return blocked.flatten(2)

    def _forward_all(self, inputs, last_only: bool = False):
        feats = self._transform_inputs(inputs)
        mask_features, levels = self.pixel_decoder(feats,
                                                   return_multi_scale=True)
        C = self.channels
        S = min(self.num_scales, len(levels))
        N = mask_features.shape[0]
        memories, mem_poss, level_mask_feats = [], [], []
        for li in range(S):
            lvl = levels[li]  # coarsest first
            h, w = lvl.shape[2:]
            mem_poss.append(position_tokens(h, w, C, lvl))
            memories.append(map_tokens(lvl)
                            + self.level_embed[li].to(lvl.dtype))
            with torch.no_grad():
                level_mask_feats.append(resize(
                    mask_features.detach(), size=(h, w), mode="bilinear",
                    align_corners=False))
        dtype = mask_features.dtype
        query_pos = self.query_embed[None].to(dtype).expand(
            N, self.num_queries, C)
        x = self.query_feat[None].to(dtype).expand(N, self.num_queries, C)
        cls, emb = self._embed(x)
        all_cls, all_embs = [cls], [emb]
        for i, layer in enumerate(self.decoder_layers()):
            li = i % S
            blocked = self._attn_blocked(all_embs[-1], level_mask_feats[li])
            x = layer(x, memories[li], query_pos, mem_poss[li], blocked)
            cls, emb = self._embed(x)
            all_cls.append(cls)
            all_embs.append(emb)
        if last_only:
            all_cls, all_embs = all_cls[-1:], all_embs[-1:]
        return all_cls, [self._mask_logits(e, mask_features)
                         for e in all_embs]
