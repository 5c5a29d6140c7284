"""The GLASS training forward and the training step.

Counterpart of ``glass_tpu/train/train_step.py`` (``TrainConfig``,
``rpn_losses``, ``glass_train_forward``) and of the step of
``glass_tpu/parallel/mesh.py`` on one device (loss, backward, optimizer
step, batch-norm updates; over ranks, ``parallel/mesh.py``'s
``make_parallel_train_step``):

* anchor labelling with the exact matcher (``matcher.py``),
* balanced subsampling as "uniform priorities, then top-k",
* gt appended to the proposals before RoI matching,
* the gt orientation written onto the sampled boxes before the mask and
  recognizer branches,
* word subsampling (``random`` / ``long_first``), masks rasterized on the
  device (``targets.py``).

A batch of B images is one program: the backbone runs on (B, H, W, 3),
each pooler is one launch over the rois of every image (K1 forward, K1b
backward: ``ops.roi_align_rotated``), the raw-image crops one launch of K2
per image.  Training-mode batch norm takes its statistics over the whole
batch, padding included, and updates the running statistics in place.

Every random choice goes through one seam, ``Priorities.uniform(site,
image, shape)``: by default an explicit ``torch.Generator`` seeded from
``SEED`` and the iteration; the parity tests plug in glass_tpu's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from contextlib import nullcontext

from ..models.fpn import FPN_LEVEL_STRIDES
from ..models.glass_rcnn import (
    GlassRCNN,
    _min_level,
    backbone_features,
    preprocess,
)
from ..models.pooler_pad import padded_pool
from ..models.recognizer import aster_decode_train, ctc_logits
from ..models.rpn import select_proposals_single_image
from ..ops.boxes import get_deltas, overwrite_orientations_on_boxes
from ..ops.crop import crop_rois
from ..ops.iou_rotated import pairwise_iou_rotated
from ..ops.roi_align_rotated import multilevel_pool, pack_batch_pyramid
from . import losses as LS
from .matcher import (
    matcher_assign,
    rpn_label_anchors,
    select_topk_mask,
    subsample_labels,
    subsample_labels_idx,
)
from .targets import mask_targets_for_proposals

class Priorities:
    """The seam of every random choice of ``glass_train_forward``: uniform
    [0, 1) draws from an explicit ``torch.Generator`` on the batch's device,
    seeded from the config's ``SEED`` and the iteration.

    ``uniform(site, image, shape)`` is called, per image, at the sites
    ``rpn_pos``/``rpn_neg`` (A,) anchor priorities, ``roi_pos``/``roi_neg``
    (P + G,) RoI priorities, ``word_strategy`` () the long_first coin,
    ``word_pick`` (R,) word priorities and ``mask`` (R,) mask-RoI
    priorities.

    ``rank`` folds a data-parallel rank into the seed, as glass_tpu folds
    ``axis_index("data")`` into each shard's key; rank 0 draws what one
    process draws."""

    def __init__(self, seed: int, iteration: int, device, rank: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(
            (int(seed) * 1_000_003 + int(iteration) + int(rank) * 0x9E3779B97F4A7C15) % (2 ** 63))

    def uniform(self, site: str, image: int, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)


@dataclass(frozen=True)
class TrainConfig:
    rpn_batch_per_image: int = 64
    rpn_positive_fraction: float = 0.5
    rpn_pre_nms_topk: int = 1000
    rpn_post_nms_topk: int = 300
    rpn_smooth_l1_beta: float = 0.11
    rpn_loss_type: str = "sine_square_loss"
    roi_batch_per_image: int = 512
    roi_positive_fraction: float = 0.25
    roi_iou_threshold: float = 0.5
    box_smooth_l1_beta: float = 1.0
    box_loss_type: str = "sine_square_loss"
    orientation_loss_weight: float = 0.3
    apply_orientation_in_training: bool = True
    recognizer_loss_weight: float = 2.0
    words_per_image: int = 8
    sample_words_strategy: str = "random"
    sample_words_strategy_prob: float = 0.3
    mask_loss_weight: float = 0.005
    masks_per_image: int = 128
    mask_size: int = 28

    @classmethod
    def from_config(cls, cfg) -> "TrainConfig":
        """glass_tpu's ``TrainConfig.from_config``, with its checks of
        ``TPU.MATCH_BACKEND`` and ``TPU.RPN_SAMPLER``; every valid value
        runs the one exact matcher and the axis sampler."""
        rec = cfg.MODEL.ROI_RECOGNIZER_HEAD
        if cfg.TPU.MATCH_BACKEND not in ("scan", "tiled"):
            raise ValueError(
                f"TPU.MATCH_BACKEND must be 'scan' or 'tiled', got {cfg.TPU.MATCH_BACKEND!r}"
            )
        if cfg.TPU.RPN_SAMPLER not in ("axis", "pool"):
            raise ValueError(f"TPU.RPN_SAMPLER must be 'axis' or 'pool', got {cfg.TPU.RPN_SAMPLER!r}")
        if cfg.TPU.RPN_SAMPLER == "pool" and cfg.TPU.MATCH_BACKEND != "tiled":
            raise ValueError(
                "TPU.RPN_SAMPLER='pool' requires TPU.MATCH_BACKEND='tiled' "
                "(positives are sampled from the matcher pools)"
            )
        return cls(
            rpn_batch_per_image=cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE,
            rpn_positive_fraction=cfg.MODEL.RPN.POSITIVE_FRACTION,
            rpn_pre_nms_topk=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
            rpn_post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN,
            rpn_smooth_l1_beta=cfg.MODEL.RPN.SMOOTH_L1_BETA,
            rpn_loss_type=cfg.MODEL.RPN.BBOX_REG_LOSS_TYPE,
            roi_batch_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
            roi_positive_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
            roi_iou_threshold=cfg.MODEL.ROI_HEADS.IOU_THRESHOLDS[0],
            box_smooth_l1_beta=cfg.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA,
            box_loss_type=cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE,
            orientation_loss_weight=cfg.MODEL.ROI_ORIENTATION_HEAD.LOSS_WEIGHT,
            apply_orientation_in_training=cfg.MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES_DURING_TRAINING,
            recognizer_loss_weight=rec.LOSS_WEIGHT,
            words_per_image=min(rec.MAX_BATCH_SIZE, cfg.TPU.MAX_WORDS),
            sample_words_strategy=rec.SAMPLE_WORDS_STRATEGY,
            sample_words_strategy_prob=rec.SAMPLE_WORDS_STRATEGY_PROB,
            mask_loss_weight=cfg.MODEL.ROI_MASK_HEAD.LOSS_WEIGHT,
            masks_per_image=int(
                cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE * cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION
            ),
        )


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image gather: arr (B, N, ...), idx (B, K) -> (B, K, ...)."""
    b = torch.arange(arr.shape[0], device=arr.device)[:, None]
    return arr[b, idx]


def rpn_losses(model: GlassRCNN, tcfg: TrainConfig, logits, deltas, anchors, gt_boxes, gt_valid,
               priorities: Priorities) -> Dict[str, torch.Tensor]:
    """Batched RPN losses (reference rotated_rpn.py:20-91).

    logits (B, A) f32; deltas (B, A, 5); anchors (A, 5); gt_boxes (B, G, 5).
    """
    arch = model.arch
    b = logits.shape[0]
    per_b = []
    for i in range(b):
        labels, matched, diag = rpn_label_anchors(gt_boxes[i], gt_valid[i], anchors)
        n = labels.shape[0]
        pos_idx, pos_val, neg_idx, neg_val = subsample_labels_idx(
            labels, tcfg.rpn_batch_per_image, tcfg.rpn_positive_fraction,
            priorities.uniform("rpn_pos", i, (n,)), priorities.uniform("rpn_neg", i, (n,)),
        )
        gt_d = get_deltas(anchors[pos_idx], gt_boxes[i][matched[pos_idx]], arch.rpn_bbox_weights)
        per_b.append((pos_idx, pos_val, neg_idx, neg_val, gt_d, diag))
    pos_idx, pos_val, neg_idx, neg_val, gt_d = (
        torch.stack([p[j] for p in per_b]) for j in range(5)
    )
    samp_logits = torch.cat([_take(logits, pos_idx), _take(logits, neg_idx)], dim=1)
    samp_tgt = torch.cat([torch.ones(pos_idx.shape, device=logits.device),
                          torch.zeros(neg_idx.shape, device=logits.device)], dim=1)
    samp_val = torch.cat([pos_val, neg_val], dim=1)
    denom = tcfg.rpn_batch_per_image * b
    objectness = LS.masked_bce_with_logits(samp_logits, samp_tgt, samp_val) * samp_val.sum() / denom
    loc = LS.BOX_REG_LOSSES[tcfg.rpn_loss_type](
        _take(deltas, pos_idx).to(torch.float32), gt_d, tcfg.rpn_smooth_l1_beta, arch.rpn_bbox_weights,
    )
    loc = torch.where(pos_val[..., None], loc, torch.zeros_like(loc)).sum() / denom
    out = {"loss_rpn_cls": objectness, "loss_rpn_loc": loc}
    for name in per_b[0][5]:
        out[name] = sum(p[5][name] for p in per_b)
    out["rpn/num_pos_anchors"] = pos_val.to(torch.float32).sum() / b
    out["rpn/num_neg_anchors"] = neg_val.to(torch.float32).sum() / b
    return out


def _anchors(model: GlassRCNN, features):
    return [model.anchors(i, f.shape[2], f.shape[3], f.device) for i, f in enumerate(features)]


def glass_train_forward(model: GlassRCNN, tcfg: TrainConfig, batch: dict,
                        priorities: Priorities, proposals=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full training forward on a batch (B leading), the model in train mode.

    batch: images (B, H, W, 3) raw BGR; content_hw (B, 2) (a host array:
    the proposals' clip box); gt_boxes (B, G, 5); gt_valid (B, G);
    gt_classes (B, G); gt_orientation (B, G); gt_text (B, G, T + 2);
    gt_polygons (B, G, K, 2); gt_poly_nv (B, G).

    ``proposals``: per image the (boxes, scores, valid) to use in place of
    the RPN's selection (the program's, replayed: the selection is a
    discrete choice that rounding may turn, and is judged on its own).

    Returns (total_loss, loss_dict); the BN running statistics of the
    model are updated in place.  Spans: ``glass.backbone``,
    ``glass.rpn_loss``, ``glass.rpn``, ``glass.box_head``,
    ``glass.recognizer``, ``glass.mask_head``.
    """
    arch = model.arch
    images = batch["images"]
    b = images.shape[0]
    gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]
    content_hw = [(int(h), int(w)) for h, w in batch["content_hw"]]
    with nullcontext():
        norm = preprocess(model, images)
        feats = backbone_features(model, norm)

    # ---- RPN ------------------------------------------------------------
    with nullcontext():
        rpn_features = [feats[f] for f in arch.rpn_in_features]
        logits_l, deltas_l = model.proposal_generator.rpn_head(rpn_features)
        anchors_l = _anchors(model, rpn_features)
        anchors = torch.cat(anchors_l, dim=0)
        logits = torch.cat([lg.to(torch.float32) for lg in logits_l], dim=1)
        deltas = torch.cat(deltas_l, dim=1)
        losses = rpn_losses(model, tcfg, logits, deltas, anchors, gt_boxes, gt_valid, priorities)

    # ---- proposals (no gradient, no content mask, as glass_tpu) ----------
    with nullcontext(), torch.no_grad():
        props = proposals or [
            select_proposals_single_image(
                [lg[i].to(torch.float32) for lg in logits_l], [d[i] for d in deltas_l],
                anchors_l, content_hw[i], arch.rpn_bbox_weights, tcfg.rpn_pre_nms_topk,
                tcfg.rpn_post_nms_topk, arch.rpn_nms_thresh,
            )
            for i in range(b)
        ]
        prop_boxes = torch.stack([p[0] for p in props])
        prop_valid = torch.stack([p[2] for p in props])
        all_boxes = torch.cat([prop_boxes, gt_boxes], dim=1)
        all_valid = torch.cat([prop_valid, gt_valid], dim=1)

        # ---- RoI matching + sampling ------------------------------------
        sel = [_label_sample(arch, tcfg, all_boxes[i], all_valid[i], gt_boxes[i], gt_valid[i],
                             batch["gt_classes"][i], priorities, i) for i in range(b)]
        sel_idx, sel_valid, sel_gt_idx, sel_cls = (torch.stack([s[j] for s in sel]) for j in range(4))
        sampled_boxes = _take(all_boxes, sel_idx)  # (B, R, 5)
        gt_boxes_per = _take(gt_boxes, sel_gt_idx)
        gt_orient_per = _take(batch["gt_orientation"], sel_gt_idx)
        fg_mask = sel_valid & (sel_cls < arch.num_classes)

    # ---- box head -------------------------------------------------------
    r = tcfg.roi_batch_per_image
    with nullcontext():
        pyr = pack_batch_pyramid(
            [feats[f].permute(0, 2, 3, 1) for f in arch.box_in_features],
            [1.0 / FPN_LEVEL_STRIDES[f] for f in arch.box_in_features],
        )
        pooled = multilevel_pool(
            pyr, _min_level(model), sampled_boxes.reshape(-1, 5),
            (arch.box_pooler_resolution, arch.box_pooler_resolution),
            arch.box_pooler_sampling_ratio, arch.pool_max_sampling_ratio,
            arch.pool_bulk_sampling_ratio, arch.pool_large_roi_budget, rois_per_image=r,
        )
        rh = model.roi_heads
        x = rh.box_head(pooled)
        scores, pred_deltas, orient_logits = rh.box_predictor(x.to(torch.float32))
        _box_losses(arch, tcfg, losses, b, scores, pred_deltas, orient_logits, sel_cls, sel_valid,
                    fg_mask, sampled_boxes, gt_boxes_per, gt_orient_per)

    with torch.no_grad():
        if tcfg.apply_orientation_in_training:
            ds_boxes = overwrite_orientations_on_boxes(sampled_boxes, gt_orient_per)
        else:
            ds_boxes = sampled_boxes

    # ---- recognizer branch ------------------------------------------------
    if arch.recognizer_on:
        with nullcontext():
            losses["loss_decoder"] = _recognizer_loss(
                model, tcfg, feats, norm, ds_boxes, fg_mask, sel_gt_idx, batch["gt_text"],
                priorities,
            )

    # ---- mask branch --------------------------------------------------------
    if arch.mask_on and "gt_polygons" in batch:
        with nullcontext():
            _mask_losses(model, tcfg, losses, pyr, ds_boxes, fg_mask, sel_gt_idx,
                         batch["gt_polygons"], batch["gt_poly_nv"], priorities)

    total = sum(v for k, v in losses.items() if k.startswith("loss"))
    return total, losses


def _label_sample(arch, tcfg, boxes_b, valid_b, gt_b, gt_v, gt_cls, priorities, image):
    """Match one image's proposals (+ gt) to its gt and sample
    ``roi_batch_per_image`` of them in ascending index order."""
    quality = pairwise_iou_rotated(gt_b, boxes_b)
    quality = quality * gt_v[:, None] * valid_b[None, :]
    matched_idx, match_labels = matcher_assign(quality, (tcfg.roi_iou_threshold,), (0, 1))
    cls = torch.where(match_labels == 1, gt_cls[matched_idx].to(torch.int64),
                      torch.full_like(matched_idx, arch.num_classes))
    sample_labels = torch.where(valid_b, torch.where(cls < arch.num_classes, 1, 0), -1)
    n = sample_labels.shape[0]
    pos_mask, neg_mask = subsample_labels(
        sample_labels, tcfg.roi_batch_per_image, tcfg.roi_positive_fraction,
        priorities.uniform("roi_pos", image, (n,)), priorities.uniform("roi_neg", image, (n,)),
    )
    idx, sel_valid = select_topk_mask(
        pos_mask | neg_mask, tcfg.roi_batch_per_image,
        -torch.arange(n, dtype=torch.float32, device=boxes_b.device),
    )
    return idx, sel_valid, matched_idx[idx], cls[idx]


def _box_losses(arch, tcfg, losses, b, scores, pred_deltas, orient_logits, sel_cls, sel_valid,
                fg_mask, sampled_boxes, gt_boxes_per, gt_orient_per):
    flat_cls = sel_cls.reshape(-1)
    flat_valid = sel_valid.reshape(-1)
    flat_fg = fg_mask.reshape(-1)
    losses["loss_cls"] = LS.masked_cross_entropy(scores, flat_cls, flat_valid)
    # Reference diagnostics: sampled fg/bg counts per image and the box
    # head's accuracy family (rotated_fast_rcnn.py:374-397).
    f32 = torch.float32
    losses["roi_head/num_fg_samples"] = flat_fg.to(f32).sum() / b
    losses["roi_head/num_bg_samples"] = (flat_valid & ~flat_fg).to(f32).sum() / b
    with torch.no_grad():
        pred_cls = torch.argmax(scores, dim=-1)
        bg_ind = scores.shape[-1] - 1
        num_inst = torch.clamp(flat_valid.to(f32).sum(), min=1.0)
        num_fg = torch.clamp(flat_fg.to(f32).sum(), min=1.0)
        losses["fast_rcnn/cls_accuracy"] = ((pred_cls == flat_cls) & flat_valid).to(f32).sum() / num_inst
        losses["fast_rcnn/fg_cls_accuracy"] = ((pred_cls == flat_cls) & flat_fg).to(f32).sum() / num_fg
        losses["fast_rcnn/false_negative"] = ((pred_cls == bg_ind) & flat_fg).to(f32).sum() / num_fg
    gt_d = get_deltas(sampled_boxes.reshape(-1, 5), gt_boxes_per.reshape(-1, 5), arch.box_bbox_weights)
    reg = LS.BOX_REG_LOSSES[tcfg.box_loss_type](
        pred_deltas.reshape(-1, 5), gt_d, tcfg.box_smooth_l1_beta, arch.box_bbox_weights
    )
    total_sampled = torch.clamp(flat_valid.sum(), min=1)
    losses["loss_box_reg"] = torch.where(flat_fg[:, None], reg, torch.zeros_like(reg)).sum() / total_sampled
    if arch.orientation_on:
        losses["loss_orientation"] = LS.masked_cross_entropy(
            orient_logits, gt_orient_per.reshape(-1), flat_fg
        ) * tcfg.orientation_loss_weight


def _recognizer_loss(model, tcfg, feats, norm, ds_boxes, fg_mask, sel_gt_idx, gt_text, priorities):
    arch = model.arch
    b = ds_boxes.shape[0]
    w_cap = tcfg.words_per_image
    with torch.no_grad():
        gt_text_per = _take(gt_text, sel_gt_idx)  # (B, R, T + 2); ctc: (B, R, T)
        word_len = (gt_text_per > 0).sum(dim=-1)
        # empty/ignored words encode to [GO][s] (token sum 1) in attention
        # mode, all zeros in ctc mode: exclude them either way
        empty_sum = 0 if model.roi_heads.recognizer_head.ctc else 1
        word_ok = fg_mask & (gt_text_per.sum(dim=-1) > empty_sum)
        picks = []
        for i in range(b):
            coin = priorities.uniform("word_strategy", i, ())
            rand_pri = priorities.uniform("word_pick", i, word_ok[i].shape)
            use_long = (coin <= tcfg.sample_words_strategy_prob) & (
                tcfg.sample_words_strategy == "long_first")
            pri = torch.where(use_long, word_len[i].to(torch.float32) + rand_pri * 0.01, rand_pri)
            picks.append(select_topk_mask(word_ok[i], w_cap, pri))
        w_idx = torch.stack([p[0] for p in picks])
        w_valid = torch.stack([p[1] for p in picks])
        word_boxes = _take(ds_boxes, w_idx)  # (B, W, 5)
        word_text = _take(gt_text_per, w_idx)  # (B, W, T + 2); ctc: (B, W, T)

    rh = model.roi_heads
    fused = rh.recognizer_feature_fusion(feats["p2"], feats["p3"]).contiguous(
        memory_format=torch.channels_last)
    pyr = pack_batch_pyramid([fused.permute(0, 2, 3, 1)], [1.0 / FPN_LEVEL_STRIDES["p2"]])
    # the pool follows the pooler padding; the raw-image crops keep the word boxes
    global_f = padded_pool(arch, word_boxes.reshape(-1, 5), lambda pool_boxes: multilevel_pool(
        pyr, 0, pool_boxes, arch.recognizer_pool_hw, 0,
        arch.pool_max_sampling_ratio, arch.recognizer_pool_bulk_sampling_ratio,
        arch.pool_large_roi_budget, rois_per_image=w_cap,
    ))
    with torch.no_grad():
        crops = torch.cat([
            crop_rois(norm[i], word_boxes[i], arch.img_crop_hw, arch.img_crop_sampling_ratio,
                      arch.crop_max_sampling_ratio)
            for i in range(b)
        ])
    crops = crops.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    local_f = rh.hybrid_net(crops)
    x = torch.cat([local_f, global_f.permute(0, 3, 1, 2)], dim=1)
    head = rh.recognizer_head
    enc = head.encode(rh.fusion_net(x)).to(torch.float32)
    targets = word_text.reshape(b * w_cap, -1)
    if head.ctc:
        loss = LS.ctc_loss_masked(ctc_logits(head.decoder, enc), targets, w_valid.reshape(-1))
    else:
        word_logits = aster_decode_train(head.aster, enc, targets, arch.max_word_len + 1)
        loss = LS.decoder_cross_entropy(word_logits, targets, w_valid.reshape(-1))
    return loss * tcfg.recognizer_loss_weight


def _mask_losses(model, tcfg, losses, pyr, ds_boxes, fg_mask, sel_gt_idx, gt_polygons, gt_poly_nv,
                 priorities):
    arch = model.arch
    b = ds_boxes.shape[0]
    m_cap = tcfg.masks_per_image
    with torch.no_grad():
        picks = [select_topk_mask(fg_mask[i], m_cap, priorities.uniform("mask", i, fg_mask[i].shape))
                 for i in range(b)]
        m_idx = torch.stack([p[0] for p in picks])
        m_valid = torch.stack([p[1] for p in picks])
        mask_boxes = _take(ds_boxes, m_idx)  # (B, M, 5)
        mask_gt_idx = _take(sel_gt_idx, m_idx)
        targets = torch.stack([
            mask_targets_for_proposals(gt_polygons[i], gt_poly_nv[i], mask_gt_idx[i], mask_boxes[i],
                                       tcfg.mask_size)
            for i in range(b)
        ]).reshape(b * m_cap, tcfg.mask_size, tcfg.mask_size)
    pooled = multilevel_pool(
        pyr, _min_level(model), mask_boxes.reshape(-1, 5),
        (arch.mask_pooler_resolution, arch.mask_pooler_resolution), 0,
        arch.pool_max_sampling_ratio, arch.mask_pool_bulk_sampling_ratio,
        arch.pool_large_roi_budget, rois_per_image=m_cap,
    )
    mask_logits = model.roi_heads.mask_head(pooled.permute(0, 3, 1, 2))[:, 0]
    elem_mask = m_valid.reshape(-1)[:, None, None].expand(targets.shape)
    losses["loss_mask"] = LS.masked_bce_with_logits(
        mask_logits, targets.to(torch.float32), elem_mask
    ) * tcfg.mask_loss_weight
    # Reference diagnostics (rotated_mask_head.py:384-396).
    with torch.no_grad():
        f32 = torch.float32
        gt_bool = targets
        incorrect = ((mask_logits > 0.0) != gt_bool) & elem_mask
        n_el = torch.clamp(elem_mask.to(f32).sum(), min=1.0)
        n_pos = (gt_bool & elem_mask).to(f32).sum()
        losses["mask_rcnn/accuracy"] = 1.0 - incorrect.to(f32).sum() / n_el
        losses["mask_rcnn/false_positive"] = (incorrect & ~gt_bool).to(f32).sum() / torch.clamp(
            n_el - n_pos, min=1.0)
        losses["mask_rcnn/false_negative"] = (incorrect & gt_bool).to(f32).sum() / torch.clamp(
            n_pos, min=1.0)
