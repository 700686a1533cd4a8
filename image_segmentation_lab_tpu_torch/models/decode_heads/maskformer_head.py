"""MaskFormer head (counterpart of ``models/decode_heads/maskformer_head.py``).

Mask classification: N learned queries each predict a (class, mask) pair,
and the semantic output is their probability-weighted combination.

* ``PixelDecoder``: an FPN top-down path (1x1 GroupNorm laterals, 3x3
  GroupNorm output convs, bilinear upsamples through ``utils/ops.resize``,
  so under grad the resize backward kernel) giving the 1/4 mask features,
  with the coarsest backbone map as the decoder's memory.
* The transformer decoder: post-norm DETR layers (query self-attention,
  query-to-memory cross-attention with a sinusoidal 2-D position encoding
  on the memory and the learned query embedding added to q and k, FFN) on
  ``(N, L, C)`` tokens; attention is ``ops/attention.biased_attention``
  (float32 scores, two matrix products).
* A linear classifier to ``num_classes + 1`` ("no object" last) and a
  3-layer mask-embedding MLP; a prediction's mask logits are one product
  of its embeddings with the mask features.
* Training: the ground-truth segments of semantic labels are the classes
  present, in ``num_classes`` padded slots with a validity mask.  The pair
  cost (-p_class, focal or binary CE, dice) is matched by the auction of
  ``ops/matching.py``, one call for every image and prediction of the step;
  the losses are CE over all queries (no-object weight 0.1) and the mask
  and dice losses of the matched pairs, for every decoder layer (keys
  ``d{i}.``-prefixed but the last).  With ``num_points > 0`` the mask
  losses take upstream Mask2Former's importance-sampled points per pair
  (oversample, keep the most uncertain, fill uniformly; targets sampled
  from the full-resolution labels, ``ops/point_sample.py``), while the
  matching costs stay dense over the mask grid against bilinear-averaged
  targets, as the JAX head computes them.  The point draws come from the
  train step's generator (``models.basic.drop.use_generator``): the head
  samples only inside it, as the JAX head samples only when it has a
  dropout rng.  Matching, costs and losses run in float32 (float64 for a
  float64 model), outside autocast.

Eval: the head returns ``log(p + 1e-8)`` of the semantic probabilities
``p = softmax(cls)[..., :-1] · sigmoid(masks)``, so the segmentor's softmax
recovers the normalised ``p``.  Only the last prediction is computed
there.  ``instance_results``, ``query_probs`` and ``panoptic_map`` give the
per-query outputs that ``val.py --instances/--panoptic`` consume.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry_hub import DECODEHEAD
from ...ops import matching
from ...ops.attention import biased_attention
from ...ops.point_sample import point_sample
from ...utils.ops import resize
from ..basic.convolution import Conv2d, Linear
from ..basic.drop import current_generator
from ..basic.normalization import LayerNorm
from ..common.conv_module import ConvModule
from ..losses import accuracy
from .decode_head import BaseDecodeHead

W_STD = 0.02  # the JAX head's trunc-normal init of every linear role


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 tensor."""
    return torch.promote_types(t.dtype, torch.float32)


@functools.lru_cache(maxsize=32)
def sine_positional_encoding(H: int, W: int, num_feats: int = 128,
                             temperature: int = 10000,
                             scale: float = 2 * math.pi,
                             device: torch.device = torch.device("cpu")
                             ) -> torch.Tensor:
    """(H, W, 2*num_feats) float32 sinusoidal 2-D embedding (normalised,
    mmdet's ``SinePositionalEncoding``)."""
    eps = 1e-6
    y = (torch.arange(1, H + 1, dtype=torch.float32, device=device)[:, None]
         / (H + eps) * scale).expand(H, W)
    x = (torch.arange(1, W + 1, dtype=torch.float32, device=device)[None, :]
         / (W + eps) * scale).expand(H, W)
    dim_t = temperature ** (2 * torch.div(
        torch.arange(num_feats, device=device), 2, rounding_mode="floor")
        / num_feats).float()
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).reshape(H, W, num_feats)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).reshape(H, W, num_feats)
    return torch.cat([pos_y, pos_x], dim=-1)


def position_tokens(H: int, W: int, channels: int, like: torch.Tensor):
    """``sine_positional_encoding`` as ``(1, H·W, channels)`` tokens in
    ``like``'s dtype and device."""
    pos = sine_positional_encoding(H, W, channels // 2, device=like.device)
    return pos.to(like.dtype).reshape(1, H * W, channels)


def map_tokens(x: torch.Tensor) -> torch.Tensor:
    """An (N, C, H, W) map as (N, H·W, C) tokens."""
    return x.flatten(2).transpose(1, 2)


class CrossAttention(nn.Module):
    """q from one stream, k and v from another, with separate projections;
    ``blocked (N, Lq, Lk)`` keys are masked out (a row that blocks every
    key attends to all)."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(embed_dims, embed_dims)
        self.k_proj = Linear(embed_dims, embed_dims)
        self.v_proj = Linear(embed_dims, embed_dims)
        self.out_proj = Linear(embed_dims, embed_dims)

    def forward(self, q_in, k_in, v_in, blocked=None):
        N, Lq, C = q_in.shape
        h = self.num_heads

        def heads(t):
            return t.view(N, -1, h, C // h).transpose(1, 2)

        mask = None
        if blocked is not None:  # one (Lq, Lk) mask an image
            mask = torch.where(blocked & ~blocked.all(-1, keepdim=True),
                               -1e30, 0.0)
        out = biased_attention(heads(self.q_proj(q_in)),
                               heads(self.k_proj(k_in)),
                               heads(self.v_proj(v_in)),
                               1.0 / math.sqrt(C // h), mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(N, Lq, C))


class DETRDecoderLayer(nn.Module):
    """Post-norm DETR decoder layer (self-attention, cross-attention,
    FFN)."""

    def __init__(self, embed_dims: int, num_heads: int,
                 feedforward_channels: int):
        super().__init__()
        self.self_attn = CrossAttention(embed_dims, num_heads)
        self.norm1 = LayerNorm(embed_dims)
        self.cross_attn = CrossAttention(embed_dims, num_heads)
        self.norm2 = LayerNorm(embed_dims)
        self.ffn_fc1 = Linear(embed_dims, feedforward_channels)
        self.ffn_fc2 = Linear(feedforward_channels, embed_dims)
        self.norm3 = LayerNorm(embed_dims)

    def forward(self, x, memory, query_pos, mem_pos):
        y = self.self_attn(x + query_pos, x + query_pos, x)
        x = self.norm1(x + y)
        y = self.cross_attn(x + query_pos, memory + mem_pos, memory)
        x = self.norm2(x + y)
        y = self.ffn_fc2(F.relu(self.ffn_fc1(x)))
        return self.norm3(x + y)


class PixelDecoder(nn.Module):
    """FPN top-down path -> (mask features at 1/4, memory = the coarsest
    backbone map), or with ``return_multi_scale`` the top-down levels,
    coarsest first, in place of the memory."""

    def __init__(self, in_channels: Sequence[int], feat_channels: int,
                 out_channels: int, norm_cfg: Optional[Dict] = None):
        super().__init__()
        ncfg = dict(norm_cfg or dict(type="GN", num_groups=32))
        self.num_levels = len(in_channels)
        for i in range(self.num_levels - 1):
            self.add_module(f"lateral{i}", ConvModule(
                in_channels[i], feat_channels, 1, norm_cfg=dict(ncfg),
                act_cfg=None))
            self.add_module(f"output{i}", ConvModule(
                feat_channels, feat_channels, 3, padding=1,
                norm_cfg=dict(ncfg), act_cfg=dict(type="ReLU")))
        self.last_feat_conv = ConvModule(
            in_channels[-1], feat_channels, 3, padding=1,
            norm_cfg=dict(ncfg), act_cfg=dict(type="ReLU"))
        self.mask_feature = Conv2d(feat_channels, out_channels, 3, padding=1)

    def forward(self, feats, return_multi_scale: bool = False):
        y = self.last_feat_conv(feats[-1])
        levels = [y]
        for i in range(self.num_levels - 2, -1, -1):
            lat = getattr(self, f"lateral{i}")(feats[i])
            y = lat + resize(y, size=lat.shape[2:], mode="bilinear",
                             align_corners=False)
            y = getattr(self, f"output{i}")(y)
            levels.append(y)
        mask_feature = self.mask_feature(y)
        if return_multi_scale:
            return mask_feature, levels
        return mask_feature, feats[-1]


def _focal_cost(mask_logits, gt_masks, alpha=0.25, gamma=2.0):
    """(N, Q, P) sigmoid-focal pair cost against (N, T, P) binary masks ->
    (N, T, Q), averaged over the points (mmdet's FocalLossCost, binary
    input)."""
    eps = 1e-12
    p = torch.sigmoid(mask_logits)
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    cost = (torch.einsum("nqp,ntp->ntq", pos, gt_masks)
            + torch.einsum("nqp,ntp->ntq", neg, 1 - gt_masks))
    return cost / mask_logits.shape[-1]


def _dice_cost(mask_logits, gt_masks, eps=1e-3):
    """(N, T, Q) dice pair cost (mmdet's DiceCost, sigmoid activation)."""
    p = torch.sigmoid(mask_logits)
    inter = 2 * torch.einsum("nqp,ntp->ntq", p, gt_masks)
    denom = p.sum(-1)[:, None, :] + gt_masks.sum(-1)[:, :, None]
    return 1 - (inter + eps) / (denom + eps)


def _bce_cost(mask_logits, gt_masks):
    """(N, T, Q) per-point binary CE pair cost averaged over the points
    (mmdet's CrossEntropyLossCost, binary input: Mask2Former's)."""
    cost = (torch.einsum("nqp,ntp->ntq", F.softplus(-mask_logits), gt_masks)
            + torch.einsum("nqp,ntp->ntq", F.softplus(mask_logits),
                           1 - gt_masks))
    return cost / mask_logits.shape[-1]


def panoptic_from_probs(probs, mask_probs,
                        object_mask_threshold: float = 0.8,
                        overlap_threshold: float = 0.8):
    """Panoptic competition on query-level probabilities (also on
    view-averaged ones, ``val.py --panoptic --tta``).

    probs (N, Q, K+1) class probabilities ("no object" last); mask_probs
    (N, Q, H, W) mask probabilities.  Returns ``(query_id (N, H, W) int64,
    the winning query or -1 for void; labels (N, Q) int64; keep (N, Q)
    bool)``: queries above ``object_mask_threshold`` compete per pixel
    with score-weighted mask probabilities, and a winner keeps its segment
    only if it holds more than ``overlap_threshold`` of its own
    thresholded mask."""
    K = probs.shape[-1] - 1
    Q = probs.shape[1]
    scores = probs[..., :-1].amax(dim=-1)
    labels = probs[..., :-1].argmax(dim=-1)
    is_object = probs.argmax(dim=-1) != K
    keep = is_object & (scores > object_mask_threshold)

    weighted = mask_probs * scores[:, :, None, None]
    weighted = torch.where(keep[:, :, None, None], weighted,
                           weighted.new_full((), -1.0))
    query_id = weighted.argmax(dim=1)
    any_kept = keep.any(dim=1)[:, None, None]

    binary = (mask_probs >= 0.5) & keep[:, :, None, None]
    won = query_id[:, None] == torch.arange(
        Q, device=query_id.device)[None, :, None, None]
    kept_area = (binary & won).sum(dim=(2, 3))
    own_area = binary.sum(dim=(2, 3)).clamp(min=1)
    keep = keep & (kept_area / own_area > overlap_threshold) \
        & (kept_area > 0)
    valid_px = any_kept & keep.gather(
        1, query_id.flatten(1)).view_as(query_id)
    query_id = torch.where(valid_px, query_id, query_id.new_full((), -1))
    return query_id, labels, keep


@DECODEHEAD.register()
class MaskFormerHead(BaseDecodeHead):
    """in_channels: the backbone pyramid's widths; channels: the embedding
    width."""

    # Mask2Former reads its memory from the pixel decoder's levels
    _uses_raw_memory = True

    def __init__(self, in_channels, channels, *,
                 num_queries: int = 100,
                 num_decoder_layers: int = 6,
                 num_heads: int = 8,
                 feedforward_channels: int = 2048,
                 feat_channels: Optional[int] = None,
                 cls_weight: float = 1.0,
                 mask_weight: float = 20.0,
                 dice_weight: float = 1.0,
                 no_object_weight: float = 0.1,
                 focal_alpha: float = 0.25,
                 focal_gamma: float = 2.0,
                 mask_loss_type: str = "focal",
                 num_points: int = 0,
                 oversample_ratio: float = 3.0,
                 importance_sample_ratio: float = 0.75,
                 **kwargs):
        super().__init__(in_channels, channels, **kwargs)
        assert self.input_transform == "multiple_select", \
            "MaskFormerHead consumes the backbone pyramid"
        assert self.out_channels in (None, self.num_classes), \
            "mask classification has no binary 1-channel mode"
        del self.conv_seg  # the queries classify
        self.num_queries = num_queries
        self.num_decoder_layers = num_decoder_layers
        self.num_heads = num_heads
        self.feedforward_channels = feedforward_channels
        self.cls_weight = cls_weight
        self.mask_weight = mask_weight
        self.dice_weight = dice_weight
        self.no_object_weight = no_object_weight
        self.focal_alpha = focal_alpha
        self.focal_gamma = focal_gamma
        self.mask_loss_type = mask_loss_type
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        C = channels
        fc = feat_channels or C
        self.feat_channels = fc
        # upstream pins GN(32); narrow widths take the common divisor
        gn = dict(type="GN", num_groups=math.gcd(32, fc))
        self.pixel_decoder = PixelDecoder(in_channels, fc, C, norm_cfg=gn)
        if self._uses_raw_memory:
            self.memory_proj = Conv2d(in_channels[-1], C, 1)
        self.query_embed = nn.Parameter(torch.zeros(num_queries, C))
        for i in range(num_decoder_layers):
            self.add_module(f"layer{i}", self._make_decoder_layer())
        self.decoder_norm = LayerNorm(C)
        self.cls_embed = Linear(C, self.num_classes + 1)
        for i in range(3):
            self.add_module(f"mask_embed{i}", Linear(C, C))

    def _make_decoder_layer(self):
        return DETRDecoderLayer(self.channels, self.num_heads,
                                self.feedforward_channels)

    def decoder_layers(self):
        return [getattr(self, f"layer{i}")
                for i in range(self.num_decoder_layers)]

    def _embedding_params(self):
        return [self.query_embed]

    def init_weights(self, generator):
        """The JAX head's init: truncated normal (std 0.02) for every
        linear, the mask-feature and memory convs and the query tables,
        zero biases; the pixel decoder's ConvModules keep the default."""
        convs = [self.pixel_decoder.mask_feature,
                 getattr(self, "memory_proj", None)]
        linears = [m for m in self.modules() if isinstance(m, nn.Linear)]
        for m in [*linears, *filter(None, convs)]:
            nn.init.trunc_normal_(m.weight, std=W_STD, generator=generator)
            nn.init.zeros_(m.bias)
        for p in self._embedding_params():
            nn.init.trunc_normal_(p, std=W_STD, generator=generator)

    # ------------------------------------------------------------ forward
    def _mask_embedding(self, x):
        for i in range(3):
            x = getattr(self, f"mask_embed{i}")(x)
            if i < 2:
                x = F.relu(x)
        return x

    @staticmethod
    def _mask_logits(emb, mask_features):
        return torch.einsum("nqc,nchw->nqhw", emb, mask_features)

    def _forward_all(self, inputs, last_only: bool = False):
        """Every prediction's ``(cls logits (N, Q, K+1), mask logits (N, Q,
        h, w))``, first to last; with ``last_only`` the last alone."""
        feats = self._transform_inputs(inputs)
        mask_features, memory = self.pixel_decoder(feats)
        C = self.channels
        mem_pos = position_tokens(*memory.shape[2:], C, memory)
        memory = map_tokens(self.memory_proj(memory))
        N = memory.shape[0]
        query_pos = self.query_embed[None].to(memory.dtype).expand(
            N, self.num_queries, C)
        x = torch.zeros_like(query_pos)
        outs = []
        for layer in self.decoder_layers():
            x = layer(x, memory, query_pos, mem_pos)
            outs.append(x)
        if last_only:
            outs = outs[-1:]
        all_cls, all_masks = [], []
        for out in outs:
            out = self.decoder_norm(out)
            all_cls.append(self.cls_embed(out))
            all_masks.append(self._mask_logits(self._mask_embedding(out),
                                               mask_features))
        return all_cls, all_masks

    def _semantic_logits(self, cls_scores, mask_preds):
        """The last prediction as per-pixel log-probabilities (N, K, h,
        w)."""
        acc = _acc_dtype(mask_preds)
        with torch.autocast(mask_preds.device.type, enabled=False):
            probs = torch.softmax(cls_scores.to(acc), dim=-1)[..., :-1]
            masks = torch.sigmoid(mask_preds.to(acc))
            sem = torch.einsum("nqk,nqhw->nkhw", probs, masks)
            return torch.log(sem + 1e-8)

    def forward(self, inputs):
        all_cls, all_masks = self._forward_all(inputs, last_only=True)
        return self._semantic_logits(all_cls[-1], all_masks[-1])

    def query_probs(self, inputs):
        """``(probs (N, Q, K+1), mask_probs (N, Q, h, w))``, float32: the
        per-query quantities that TTA views average (queries are the same
        learned slots in every view)."""
        all_cls, all_masks = self._forward_all(inputs, last_only=True)
        acc = _acc_dtype(all_masks[-1])
        with torch.autocast(all_masks[-1].device.type, enabled=False):
            return (torch.softmax(all_cls[-1].to(acc), dim=-1),
                    torch.sigmoid(all_masks[-1].to(acc)))

    def instance_results(self, inputs, score_threshold: float = 0.0):
        """``(labels (N, Q), scores (N, Q), masks (N, Q, h, w) bool)``: the
        argmax class, its probability (0 below ``score_threshold`` or where
        "no object" wins) and sigmoid > 0.5."""
        probs, mask_probs = self.query_probs(inputs)
        labels = probs[..., :-1].argmax(dim=-1)
        scores = probs[..., :-1].amax(dim=-1)
        is_object = probs.argmax(dim=-1) != self.num_classes
        scores = torch.where(is_object & (scores > score_threshold), scores,
                             scores.new_zeros(()))
        return labels, scores, mask_probs > 0.5

    def panoptic_map(self, inputs, object_mask_threshold: float = 0.8,
                     overlap_threshold: float = 0.8):
        """MaskFormer's panoptic post-processing (``panoptic_from_probs``)
        at the mask resolution."""
        probs, mask_probs = self.query_probs(inputs)
        return panoptic_from_probs(probs, mask_probs, object_mask_threshold,
                                   overlap_threshold)

    # ------------------------------------------------------------- losses
    def _pair_cost(self, cls_scores, mask_logits, gt_masks):
        """(N, K, Q) matching cost of one prediction: ``mask_logits (N, Q,
        P)`` against ``gt_masks (N, K, P)``."""
        if self.mask_loss_type == "ce":
            mask_cost = _bce_cost(mask_logits, gt_masks)
        else:
            mask_cost = _focal_cost(mask_logits, gt_masks, self.focal_alpha,
                                    self.focal_gamma)
        probs = torch.softmax(cls_scores, dim=-1)
        cls_cost = -probs[..., :self.num_classes].transpose(1, 2)
        return (self.cls_weight * cls_cost + self.mask_weight * mask_cost
                + self.dice_weight * _dice_cost(mask_logits, gt_masks))

    def _point_draws(self, shape, device):
        """Uniform points of every pair: ``(oversampled (*shape, n_os, 2),
        uniform fill (*shape, n_rand, 2))`` from the installed
        generator."""
        n_os = int(self.num_points * self.oversample_ratio)
        n_rand = self.num_points - int(self.num_points
                                       * self.importance_sample_ratio)
        g = current_generator()
        return (torch.rand((*shape, n_os, 2), generator=g, device=device),
                torch.rand((*shape, n_rand, 2), generator=g, device=device))

    def _loss_points(self, sel_maps):
        """Upstream's ``get_uncertain_point_coords_with_randomness`` for
        every pair: ``sel_maps (..., h, w)`` (no grad) -> points (...,
        num_points, 2): the ``importance_sample_ratio`` most uncertain of
        the oversampled points, then the uniform fill."""
        lead = sel_maps.shape[:-2]
        os_pts, rand_pts = self._point_draws(lead, sel_maps.device)
        maps = sel_maps.reshape(-1, 1, *sel_maps.shape[-2:])
        os_pts = os_pts.reshape(maps.shape[0], -1, 2)
        unc = -point_sample(maps, os_pts)[:, 0].abs()
        n_imp = int(self.num_points * self.importance_sample_ratio)
        top = torch.topk(unc, n_imp, dim=1).indices
        imp = os_pts.gather(1, top[..., None].expand(-1, -1, 2))
        pts = torch.cat([imp, rand_pts.reshape(maps.shape[0], -1, 2)],
                        dim=1)
        return pts.view(*lead, self.num_points, 2)

    def _matched_losses(self, all_cls, all_masks, gt_masks, valid,
                        gt_match=None):
        """Per prediction and image ``(loss_cls, loss_mask, loss_dice)``,
        each (L, N), weighted.  ``gt_masks (N, K, H, W)``: at the mask
        resolution (dense path) or the labels' (point path, with
        ``gt_match`` the bilinear-averaged targets at the mask resolution
        for the costs)."""
        L, (N, Q) = len(all_cls), all_cls[0].shape[:2]
        K = self.num_classes
        acc = _acc_dtype(all_masks[0])
        sampled = gt_match is not None
        with torch.no_grad():
            gm = (gt_match if sampled else gt_masks).flatten(2).to(acc)
            cost = torch.stack([self._pair_cost(c.to(acc), m.flatten(2).to(acc),
                                                gm)
                                for c, m in zip(all_cls, all_masks)])
            col, _ = matching.auction_assignment(
                cost.flatten(0, 1), valid.repeat(L, 1))
        col = col.view(L, N, K)
        # a valid row may end unassigned (-1) if the auction runs out of
        # rounds: gate every index on it
        matched = valid[None] & (col >= 0)
        col = torch.where(matched, col, col.new_zeros(()))

        # classification: a matched query takes its class, the rest "no
        # object"
        hit = (col[..., None] == torch.arange(Q, device=col.device)) \
            & matched[..., None]                            # (L, N, K, Q)
        labels = torch.where(hit.any(dim=2), hit.long().argmax(dim=2),
                             torch.full_like(col[:, :, :1], K))
        cls = torch.stack(all_cls).to(acc)
        logp = torch.log_softmax(cls, dim=-1)
        cw = torch.ones(K + 1, dtype=acc, device=cls.device)
        cw[K] = self.no_object_weight
        w = cw[labels]
        ce = -logp.gather(-1, labels[..., None])[..., 0] * w
        loss_cls = ce.sum(-1) / w.sum(-1).clamp(min=1.0)

        # masks: on the matched pairs only
        batch = torch.arange(N, device=col.device)[:, None]
        if sampled:
            sel_maps = torch.stack([m[batch, c] for m, c in
                                    zip(all_masks, col)])  # (L, N, K, h, w)
            pts = self._loss_points(sel_maps.detach())
            sel = point_sample(sel_maps.flatten(0, 2)[:, None],
                               pts.flatten(0, 2))[:, 0].view(L, N, K, -1)
            # every prediction's points on one (N·K) stack of label maps
            g = point_sample(gt_masks.flatten(0, 1)[:, None].to(acc),
                             pts.permute(1, 2, 0, 3, 4).reshape(
                                 N * K, -1, 2))[:, 0]
            g = g.view(N, K, L, -1).permute(2, 0, 1, 3)
        else:
            sel = torch.stack([m.flatten(2)[batch, c] for m, c in
                               zip(all_masks, col)])        # (L, N, K, P)
            g = gt_masks.flatten(2).to(acc)[None]
        x = sel.to(acc)
        p = torch.sigmoid(x)
        if self.mask_loss_type == "ce":
            per_pt = g * F.softplus(-x) + (1 - g) * F.softplus(x)
        else:
            per_pt = (-g * torch.log(p + 1e-12) * self.focal_alpha
                      * (1 - p) ** self.focal_gamma
                      - (1 - g) * torch.log(1 - p + 1e-12)
                      * (1 - self.focal_alpha) * p ** self.focal_gamma)
        vf = matched.to(acc)
        n_masks = vf.sum(-1).clamp(min=1.0)
        loss_mask = (per_pt.mean(-1) * vf).sum(-1) / n_masks
        inter = 2 * (p * g).sum(-1)
        dice = 1 - (inter + 1e-3) / (p.sum(-1) + g.sum(-1) + 1e-3)
        loss_dice = (dice * vf).sum(-1) / n_masks
        return (self.cls_weight * loss_cls, self.mask_weight * loss_mask,
                self.dice_weight * loss_dice)

    def forward_train(self, inputs, gt_semantic_seg, meta_infos=None,
                      rescale: bool = False):
        all_cls, all_masks = self._forward_all(inputs)
        label = gt_semantic_seg.long()
        K = self.num_classes
        acc = _acc_dtype(all_masks[-1])
        h, w = all_masks[-1].shape[-2:]
        with torch.autocast(label.device.type, enabled=False):
            valid_px = label != self.ignore_index
            onehot = ((label[:, None] == torch.arange(
                K, device=label.device)[None, :, None, None])
                & valid_px[:, None]).to(acc)                # (N, K, H, W)
            valid = onehot.sum(dim=(2, 3)) > 0              # (N, K)
            if self.num_points > 0 and current_generator() is not None:
                # the point path: losses sample the full-resolution
                # targets, the costs run against bilinear-averaged ones
                gt_masks, gt_match = onehot, resize(
                    onehot, size=(h, w), mode="bilinear",
                    align_corners=False)
            else:
                gt_masks, gt_match = (resize(
                    onehot, size=(h, w), mode="bilinear",
                    align_corners=False) > 0.5).to(acc), None
            lc, lm, ld = self._matched_losses(all_cls, all_masks, gt_masks,
                                              valid, gt_match)
            loss = {}
            for li in range(len(all_cls)):
                tag = "" if li == len(all_cls) - 1 else f"d{li}."
                loss[f"{tag}loss_cls"] = lc[li].mean()
                loss[f"{tag}loss_mask"] = lm[li].mean()
                loss[f"{tag}loss_dice"] = ld[li].mean()
            sem = self._semantic_logits(all_cls[-1], all_masks[-1])
            sem = resize(sem, size=label.shape[1:], mode="bilinear",
                         align_corners=self.align_corners)
            loss["acc_seg"] = accuracy(sem, label,
                                       ignore_index=self.ignore_index)
        ori_img_size = (meta_infos or {}).get("ori_img_size_hw")
        if rescale and ori_img_size and isinstance(ori_img_size, tuple):
            sem = resize(sem, size=ori_img_size, mode="bilinear",
                         align_corners=self.align_corners)
        return sem, loss
