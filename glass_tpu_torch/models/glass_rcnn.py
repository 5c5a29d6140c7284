"""GLASS R-CNN at inference: the full image -> words path.

Counterpart of ``glass_tpu/models/glass_rcnn.py``:

    normalize -> ResNet-50 + FPN -> rotated RPN -> box head (+orientation)
    -> rotated NMS -> [P2P3 fusion + 8x32 pool of the fused P2 | 128x128
    raw-image crops -> local CNN] -> channel concat -> GC attention ->
    CNN_V1_1 -> BiLSTM -> greedy ASTER decode  (+ 14x14 mask head)

and every recognizer-side option glass_tpu selects from the config:
FeatPadV2 (``RECOGNIZER_HEAD.POOLER_PAD``: the pool takes the widened
boxes, the crops the original ones), the fusion modules
(``HYBRID_FUSION.{NAME,FUSION_TYPE}``), the recognizer CNNs
(``RECOGNIZER_HEAD.BACKBONE``), the CTC head (``RECOGNIZER_HEAD.DECODER``:
per-step softmax, (D, 32, V)) and the local extractors
(``LOCAL_FEATURE_EXTRACTOR.NAME``).

It keeps glass_tpu's fixed-capacity padded sets with validity masks, so
the port computes the same function on the same padded bucket: the padded
border changes features near the edge, anchors whose centres fall beyond
the stride-32 extent of the content are masked, and the recognizer and
mask head run on all ``DETECTIONS_PER_IMAGE`` rows, invalid ones included
(the decoder's batch-global stop depends on them).

Every stage is written over a batch of padded images, and its one-image
function is the batch of one.  ``glass_inference_batch`` runs one program
over a batch (``TPU.SERVE_BATCH_MODE="vmap"``, glass_tpu's ``jax.vmap`` of
``glass_inference_single``): one backbone call over the batch, one batched
NMS a stage, the poolers over the batch's packed pyramid with each image's
own large-roi budget, the crops of every image in one launch, and the
decoder's break per image.  Each image's fields are those of its own
``glass_inference_single`` up to rounding (the batch's convolutions and
matrix products may add in another order).

Every rotated pool is one launch of kernel K1 (``ops/roi_align_rotated``)
and the raw-image crop one launch of kernel K2 (``ops/crop``), for one
image or a batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from .box_head import (
    Detections,
    FastRCNNConvFCHead,
    RotatedFastRCNNOutputLayers,
    fast_rcnn_inference_batch,
)
from .fpn import FPN_LEVEL_STRIDES, ResNetFPN
from .fusion import P2P3Fusion, build_fusion
from .local_extractor import build_local_extractor
from .mask_head import MaskRCNNConvUpsampleHead, mask_inference_probs
from .pooler_pad import padded_pool
from .recognizer import RecognizerHead, aster_decode_greedy, ctc_logits
from . import rpn as rpn_mod
from ..ops.boxes import apply_deltas
from ..ops.crop import crop_rois_batched
from ..ops.nms_rotated import NEG_INF
from ..ops.roi_align_rotated import (
    PackedPyramid,
    multilevel_pool,
    pack_batch_pyramid,
)
from ..utils import trace

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class GlassArch:
    """Static architecture hyperparameters (derived from a CfgNode); the
    fields and defaults of glass_tpu's ``GlassArch`` that inference and
    training read.  Its backend choices (TPU.ROI_ALIGN_BACKEND,
    TPU.CROP_BACKEND, TPU.STEM_BACKEND) pick TPU realisations of one
    function, which the port computes with its own kernels and its plain
    stem."""

    pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    anchor_sizes: Tuple[Tuple[float, ...], ...] = ((16,), (32,), (64,), (128,), (256,))
    anchor_aspects: Tuple[float, ...] = (0.2, 0.5, 1.0)
    anchor_angles: Tuple[float, ...] = (-90, -45, 0, 45)
    anchor_offset: float = 0.0
    rpn_in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5", "p6")
    rpn_bbox_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 2.0)
    rpn_pre_nms_topk: int = 1000
    rpn_post_nms_topk: int = 100
    rpn_nms_thresh: float = 0.7
    box_in_features: Tuple[str, ...] = ("p2", "p3", "p4", "p5", "p6")
    box_pooler_resolution: int = 7
    box_pooler_sampling_ratio: int = 2
    box_bbox_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0, 10.0)
    box_fc_dim: int = 2048
    num_classes: int = 1
    score_thresh: float = 0.05
    nms_thresh: float = 0.35
    detections_per_image: int = 100
    orientation_on: bool = True
    apply_orientation_to_boxes: bool = True
    recognizer_on: bool = True
    recognizer_in_features: Tuple[str, ...] = ("p2", "p3")
    recognizer_pool_hw: Tuple[int, int] = (8, 32)
    img_crop_hw: Tuple[int, int] = (128, 128)
    img_crop_sampling_ratio: int = 0
    crop_max_sampling_ratio: int = 2
    pool_max_sampling_ratio: int = 4
    pool_bulk_sampling_ratio: int = 2
    pool_large_roi_budget: int = 16
    mask_pool_bulk_sampling_ratio: tuple = (1, 2)
    recognizer_pool_bulk_sampling_ratio: tuple = (2, 1)
    max_word_len: int = 25
    vocab_size: int = 97
    gc_headers: int = 8
    pooler_pad: str = ""
    recognizer_backbone: str = "CNN_V1_1"
    recognizer_decoder: str = "ASTER_V2"
    local_extractor_name: str = "ResNetFeatureExtractor"
    fusion_name: str = "MultiAspectGCAttention"
    fusion_type: str = "channel_add"
    mask_on: bool = True
    mask_inference: bool = False
    mask_pooler_resolution: int = 14
    mask_num_conv: int = 4
    freeze_at: int = 0
    compute_dtype: str = "float32"
    remat_backbone: bool = False
    text_emit: str = "topk"
    mask_fetch_dtype: str = "float16"

    @classmethod
    def from_config(cls, cfg) -> "GlassArch":
        if cfg.MODEL.ROI_RECOGNIZER_HEAD.NAME == "RecognizerRCNNHeadV3":
            rec = cfg.MODEL.ROI_RECOGNIZER_HEAD
        else:  # legacy configs route the recognizer through ROI_MASK_HEAD
            rec = cfg.MODEL.ROI_MASK_HEAD
        if cfg.MODEL.ROI_HEADS.NUM_CLASSES != 1:
            raise NotImplementedError(
                "glass_tpu_torch supports NUM_CLASSES == 1 (the GLASS 'word' "
                f"class); got {cfg.MODEL.ROI_HEADS.NUM_CLASSES}"
            )
        decoder_name = rec.RECOGNIZER_HEAD.DECODER.NAME
        if cfg.MODEL.RECOGNIZER_ON and ((decoder_name == "CTC") != (rec.LABELS_TYPE == "ctc")):
            raise ValueError(
                "Inconsistent recognizer config: RECOGNIZER_HEAD.DECODER."
                f"NAME={decoder_name!r} requires LABELS_TYPE="
                f"{'ctc' if decoder_name == 'CTC' else 'attention'!r}, got "
                f"LABELS_TYPE={rec.LABELS_TYPE!r}"
            )
        # ResNetFeatureExtractorV2 emits a crop/4 map, which the recognizer
        # concatenates with the global pool: glass_tpu's shape contract
        if cfg.MODEL.RECOGNIZER_ON and (
            cfg.MODEL.LOCAL_FEATURE_EXTRACTOR.NAME == "ResNetFeatureExtractorV2"
        ):
            crop_hw = (rec.POOLER_RESOLUTION_HEIGHT * 16, rec.POOLER_RESOLUTION_WIDTH * 4)
            v2_out = (crop_hw[0] // 4, crop_hw[1] // 4)
            pool_hw = (rec.POOLER_RESOLUTION_HEIGHT, rec.POOLER_RESOLUTION_WIDTH)
            if v2_out != pool_hw:
                raise ValueError(
                    "ResNetFeatureExtractorV2 emits a crop/4 feature map "
                    f"({v2_out[0]}x{v2_out[1]} from the {crop_hw[0]}x{crop_hw[1]} crop) but the "
                    f"recognizer concatenates it with the {pool_hw[0]}x{pool_hw[1]} global pool; "
                    "set POOLER_RESOLUTION_HEIGHT/WIDTH so crop/4 matches the pool (e.g. the "
                    "default extractor instead, which emits crop/16 x crop/4)."
                )

        def _grid(v):
            return tuple(v) if isinstance(v, (tuple, list)) else v

        return cls(
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            anchor_sizes=tuple(tuple(s) for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES),
            anchor_aspects=tuple(cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
            anchor_angles=tuple(cfg.MODEL.ANCHOR_GENERATOR.ANGLES[0]),
            anchor_offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
            rpn_in_features=tuple(cfg.MODEL.RPN.IN_FEATURES),
            rpn_bbox_weights=tuple(cfg.MODEL.RPN.BBOX_REG_WEIGHTS),
            rpn_pre_nms_topk=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
            rpn_post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
            rpn_nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
            box_in_features=tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES),
            box_pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
            box_pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
            box_bbox_weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
            box_fc_dim=cfg.MODEL.ROI_BOX_HEAD.FC_DIM,
            num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
            score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            orientation_on=cfg.MODEL.ORIENTATION_ON,
            apply_orientation_to_boxes=cfg.MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES,
            recognizer_on=cfg.MODEL.RECOGNIZER_ON,
            recognizer_in_features=tuple(rec.IN_FEATURES),
            recognizer_pool_hw=(rec.POOLER_RESOLUTION_HEIGHT, rec.POOLER_RESOLUTION_WIDTH),
            img_crop_hw=(rec.POOLER_RESOLUTION_HEIGHT * 16, rec.POOLER_RESOLUTION_WIDTH * 4),
            img_crop_sampling_ratio=cfg.TPU.CROP_SAMPLING_RATIO,
            crop_max_sampling_ratio=cfg.TPU.CROP_MAX_SAMPLING_RATIO,
            pool_max_sampling_ratio=cfg.TPU.POOL_MAX_SAMPLING_RATIO,
            pool_bulk_sampling_ratio=cfg.TPU.POOL_BULK_SAMPLING_RATIO,
            pool_large_roi_budget=cfg.TPU.POOL_LARGE_ROI_BUDGET,
            mask_pool_bulk_sampling_ratio=_grid(cfg.TPU.MASK_POOL_BULK_SAMPLING_RATIO),
            recognizer_pool_bulk_sampling_ratio=_grid(cfg.TPU.RECOGNIZER_POOL_BULK_SAMPLING_RATIO),
            max_word_len=rec.MAX_WORD_LENGTH,
            vocab_size=len(rec.CHARACTER_SET) + (2 if rec.LABELS_TYPE == "attention" else 1),
            gc_headers=cfg.MODEL.HYBRID_FUSION.HEADERS,
            pooler_pad=rec.RECOGNIZER_HEAD.POOLER_PAD.NAME,
            recognizer_backbone=rec.RECOGNIZER_HEAD.BACKBONE.NAME,
            recognizer_decoder=rec.RECOGNIZER_HEAD.DECODER.NAME,
            local_extractor_name=cfg.MODEL.LOCAL_FEATURE_EXTRACTOR.NAME,
            fusion_name=cfg.MODEL.HYBRID_FUSION.NAME,
            fusion_type=cfg.MODEL.HYBRID_FUSION.FUSION_TYPE,
            mask_on=cfg.MODEL.MASK_ON,
            mask_inference=cfg.MODEL.ROI_MASK_HEAD.MASK_INFERENCE,
            mask_pooler_resolution=cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION,
            mask_num_conv=cfg.MODEL.ROI_MASK_HEAD.NUM_CONV,
            freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
            compute_dtype=cfg.TPU.COMPUTE_DTYPE,
            remat_backbone=cfg.TPU.REMAT_BACKBONE,
            text_emit=cfg.TPU.TEXT_EMIT,
            mask_fetch_dtype=cfg.TPU.MASK_FETCH_DTYPE,
        )

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_aspects) * len(self.anchor_angles) * len(self.anchor_sizes[0])

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def _check_ported(arch: GlassArch) -> None:
    """The model options the port runs, in serving and in training: every
    ``TPU.COMPUTE_DTYPE`` glass_tpu takes (float32, bfloat16, float16),
    with or without ``TPU.REMAT_BACKBONE``.  Any other compute dtype fails
    here rather than deep inside the model."""
    if arch.compute_dtype not in _DTYPES:
        raise ValueError(
            f"TPU.COMPUTE_DTYPE={arch.compute_dtype!r}: expected one of {sorted(_DTYPES)}"
        )


class GlassRCNN(nn.Module):
    """The model's modules under detectron2/GLASS names, so ``state_dict()``
    is shaped like a released ``.pth`` (see ``glass_tpu_torch.weights``)."""

    def __init__(self, arch: GlassArch):
        super().__init__()
        _check_ported(arch)
        self.arch = arch
        self.backbone = ResNetFPN(256, arch.freeze_at)
        self.proposal_generator = nn.Module()
        self.proposal_generator.rpn_head = rpn_mod.StandardRPNHead(256, arch.num_anchors)
        rh = nn.Module()
        rh.box_head = FastRCNNConvFCHead(256 * arch.box_pooler_resolution**2, arch.box_fc_dim)
        rh.box_predictor = RotatedFastRCNNOutputLayers(
            arch.box_fc_dim, arch.num_classes, arch.orientation_on
        )
        if arch.recognizer_on:
            rh.recognizer_feature_fusion = P2P3Fusion(256)
            rh.hybrid_net = build_local_extractor(arch.local_extractor_name, 256)
            rh.fusion_net = build_fusion(arch.fusion_name, arch.fusion_type, 512, 0.5,
                                         arch.gc_headers, 256)
            rh.recognizer_head = RecognizerHead(256, arch.vocab_size, arch.recognizer_backbone,
                                                arch.recognizer_decoder)
        if arch.mask_on:
            rh.mask_head = MaskRCNNConvUpsampleHead(256, 256, arch.mask_num_conv, arch.num_classes)
        self.roi_heads = rh
        # Not part of a checkpoint: derived from the config, kept on the
        # model's device so no image uploads them again.
        self.register_buffer("pixel_mean", torch.tensor(arch.pixel_mean, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(arch.pixel_std, dtype=torch.float32),
                             persistent=False)
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors(self, level: int, h: int, w: int, device) -> torch.Tensor:
        """(h*w*A, 5) anchors of one RPN level, cached per shape and device."""
        key = (level, h, w, str(device))
        if key not in self._anchors:
            arch = self.arch
            cell = rpn_mod.generate_cell_anchors(
                arch.anchor_sizes[level], arch.anchor_aspects, arch.anchor_angles
            )
            stride = FPN_LEVEL_STRIDES[arch.rpn_in_features[level]]
            anc = rpn_mod.generate_anchors_for_level(h, w, stride, cell, arch.anchor_offset)
            self._anchors[key] = torch.from_numpy(anc).to(device)
        return self._anchors[key]


# ---------------------------------------------------------------------------
# forward pieces (glass_tpu names)
# ---------------------------------------------------------------------------


def nhwc(feature: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) map of one image -> (H, W, C) channels-last view."""
    return feature[0].permute(1, 2, 0)


def preprocess(model: GlassRCNN, image: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) raw BGR 0-255 -> normalized, in the compute dtype."""
    norm = (image.to(torch.float32) - model.pixel_mean) / model.pixel_std
    return norm.to(model.arch.torch_dtype)


def backbone_features(model: GlassRCNN, norm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """norm (H, W, 3) or a batch (B, H, W, 3) -> {p2..p6} as (B, C, h, w)
    (B = 1 for one image) in channels-last memory."""
    x = norm[None] if norm.dim() == 3 else norm
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return model.backbone(x)


def rpn_proposals_batch(model: GlassRCNN, feats, image_sizes):
    """-> proposal boxes (B, P, 5), scores (B, P), valid (B, P).

    image_sizes: a (B, 2) f32 tensor of each image's content (h, w) on the
    features' device, or one (h, w) for every image."""
    arch = model.arch
    features = [feats[f] for f in arch.rpn_in_features]
    logits, deltas = model.proposal_generator.rpn_head(features)
    # Mask anchors whose centres lie beyond the content's stride-32 extent:
    # the reference pads only to stride divisibility, so bucket padding must
    # not add proposals it would never see.
    if torch.is_tensor(image_sizes):
        extent = torch.ceil(image_sizes / 32.0) * 32.0
        max_h, max_w = extent[:, 0, None], extent[:, 1, None]
    else:
        max_h = math.ceil(image_sizes[0] / 32.0) * 32.0
        max_w = math.ceil(image_sizes[1] / 32.0) * 32.0
    anchors, masked = [], []
    for i, f in enumerate(features):
        anc = model.anchors(i, f.shape[2], f.shape[3], f.device)
        inside = (anc[:, 0] < max_w) & (anc[:, 1] < max_h)
        lg = logits[i].to(torch.float32)
        anchors.append(anc)
        masked.append(torch.where(inside, lg, torch.full_like(lg, NEG_INF)))
    return rpn_mod.select_proposals_batch(
        masked, deltas, anchors, image_sizes, arch.rpn_bbox_weights,
        arch.rpn_pre_nms_topk, arch.rpn_post_nms_topk, arch.rpn_nms_thresh,
    )


def rpn_proposals_single(model: GlassRCNN, feats, content_hw):
    """-> proposal boxes (P, 5), scores (P,), valid (P,)."""
    return tuple(t[0] for t in rpn_proposals_batch(model, feats, content_hw))


def pack_box_pyramid(model: GlassRCNN, feats) -> PackedPyramid:
    """The box/mask poolers' levels of every image of the features' batch,
    packed once."""
    names = model.arch.box_in_features
    return pack_batch_pyramid([feats[f].permute(0, 2, 3, 1) for f in names],
                              [1.0 / FPN_LEVEL_STRIDES[f] for f in names])


def _min_level(model: GlassRCNN) -> int:
    return FPN_LEVEL_STRIDES[model.arch.box_in_features[0]].bit_length() - 1


def detect_batch(model: GlassRCNN, feats, pyr: PackedPyramid, image_sizes) -> Detections:
    """RPN + box head + NMS for a batch of padded images: Detections with a
    leading (B,).  image_sizes as ``rpn_proposals_batch``; the box pooler
    takes the B * P proposals in one launch, each image's with its own
    large-roi budget."""
    arch = model.arch
    with trace.span("glass.rpn"):
        prop_boxes, _, prop_valid = rpn_proposals_batch(model, feats, image_sizes)
    b, p = prop_valid.shape
    with trace.span("glass.box_head"):
        rois = prop_boxes.reshape(-1, 5)
        pooled = multilevel_pool(
            pyr, _min_level(model), rois,
            (arch.box_pooler_resolution, arch.box_pooler_resolution),
            arch.box_pooler_sampling_ratio, arch.pool_max_sampling_ratio,
            arch.pool_bulk_sampling_ratio, arch.pool_large_roi_budget, rois_per_image=p,
        )
        rh = model.roi_heads
        x = rh.box_head(pooled).to(torch.float32)
        scores, deltas, orient = rh.box_predictor(x)
        probs = torch.softmax(scores, dim=-1)
        boxes = apply_deltas(deltas, rois, arch.box_bbox_weights)
        return fast_rcnn_inference_batch(
            boxes.view(b, p, 5), probs.view(b, p, -1), None if orient is None else orient.view(b, p, -1),
            prop_valid, image_sizes, arch.score_thresh, arch.nms_thresh,
            arch.detections_per_image, arch.apply_orientation_to_boxes and arch.orientation_on,
        )


def detect_single_image(model: GlassRCNN, feats, pyr: PackedPyramid, content_hw) -> Detections:
    """RPN + box head + NMS for one padded image."""
    return Detections(*(t[0] for t in detect_batch(model, feats, pyr, content_hw)))


def recognizer_encode_batch(model: GlassRCNN, feats, norm_images, boxes, raw_images=None):
    """P2P3 fusion -> 8x32 pool + raw-image crops -> local CNN -> fusion
    -> recognizer CNN -> BiLSTM over a batch: norm_images (B, H, W, 3),
    boxes (B, D, 5) -> encoder states (B * D, T, C), image-major.  The 8x32
    pool is one launch over the batch-packed fused map (each image's own
    large-roi budget), the crops one launch over the batch.  Under FeatPadV2
    the pool takes the widened boxes and its padding columns are zeroed;
    the crops take ``boxes`` as they are.

    raw_images: the (B, H, W, 3) uint8 images; when given, the crops are
    pooled from them with the normalization folded in.
    """
    arch = model.arch
    rh = model.roi_heads
    d = boxes.shape[1]
    # channels-last, so the pooler reads the map in place (no copy)
    fused = rh.recognizer_feature_fusion(feats["p2"], feats["p3"]).contiguous(
        memory_format=torch.channels_last)
    pyr = pack_batch_pyramid([fused.permute(0, 2, 3, 1)], [1.0 / FPN_LEVEL_STRIDES["p2"]])
    global_feats = padded_pool(arch, boxes.reshape(-1, 5), lambda pool_boxes: multilevel_pool(
        pyr, 0, pool_boxes, arch.recognizer_pool_hw, 0, arch.pool_max_sampling_ratio,
        arch.recognizer_pool_bulk_sampling_ratio, arch.pool_large_roi_budget, rois_per_image=d,
    ))
    if raw_images is not None:
        crops = crop_rois_batched(raw_images, boxes, arch.img_crop_hw, arch.img_crop_sampling_ratio,
                                  arch.crop_max_sampling_ratio,
                                  normalize=(model.pixel_mean, model.pixel_std))
        crops = crops.to(arch.torch_dtype)
    else:
        crops = crop_rois_batched(norm_images, boxes, arch.img_crop_hw, arch.img_crop_sampling_ratio,
                                  arch.crop_max_sampling_ratio)
    crops = crops.flatten(0, 1).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    local_feats = rh.hybrid_net(crops)
    x = torch.cat([local_feats, global_feats.permute(0, 3, 1, 2)], dim=1)
    return rh.recognizer_head.encode(rh.fusion_net(x))


def recognizer_encode(model: GlassRCNN, feats, norm_image, boxes, raw_image=None):
    """``recognizer_encode_batch`` of one image: norm_image (H, W, 3),
    boxes (D, 5) -> encoder states (D, T, C)."""
    return recognizer_encode_batch(model, feats, norm_image[None], boxes[None],
                                   None if raw_image is None else raw_image[None])


def recognize_batch(model: GlassRCNN, feats, norm_images, boxes, raw_images=None):
    """boxes (B, D, 5) -> (B, D, max_word_len + 1, V) per-step character
    probabilities; CTC: (B, D, T, V) per-timestep probabilities (T = 32,
    the encoder's steps), which the codec's CTC decoding collapses.  The
    greedy decoder breaks per image, as glass_tpu's under ``jax.vmap``."""
    b, d = boxes.shape[:2]
    enc = recognizer_encode_batch(model, feats, norm_images, boxes, raw_images).to(torch.float32)
    head = model.roi_heads.recognizer_head
    if head.ctc:
        probs = torch.softmax(ctc_logits(head.decoder, enc), dim=-1)
    else:
        probs = aster_decode_greedy(head.aster, enc, model.arch.max_word_len + 1, group=d)
    return probs.view((b, d) + probs.shape[1:])


def recognize_single_image(model: GlassRCNN, feats, norm_image, boxes, raw_image=None):
    """``recognize_batch`` of one image: boxes (D, 5) -> (D, steps, V)."""
    return recognize_batch(model, feats, norm_image[None], boxes[None],
                           None if raw_image is None else raw_image[None])[0]


def mask_batch(model: GlassRCNN, pyr: PackedPyramid, boxes, classes):
    """boxes (B, D, 5), classes (B, D) -> (B, D, 28, 28) mask
    probabilities.  The 14x14 pool is adaptive, capped at
    POOL_MAX_SAMPLING_RATIO, with the bulk grid + large-roi budget of
    glass_tpu (each image its own), one launch over the batch."""
    arch = model.arch
    b, d = boxes.shape[:2]
    pooled = multilevel_pool(
        pyr, _min_level(model), boxes.reshape(-1, 5),
        (arch.mask_pooler_resolution, arch.mask_pooler_resolution), 0,
        arch.pool_max_sampling_ratio, arch.mask_pool_bulk_sampling_ratio,
        arch.pool_large_roi_budget, rois_per_image=d,
    )
    logits = model.roi_heads.mask_head(pooled.permute(0, 3, 1, 2))
    probs = mask_inference_probs(logits.to(torch.float32), classes.reshape(-1))
    return probs.view((b, d) + probs.shape[1:])


def mask_single_image(model: GlassRCNN, pyr: PackedPyramid, boxes, classes):
    """-> (D, 28, 28) mask probabilities of one image."""
    return mask_batch(model, pyr, boxes[None], classes[None])[0]


def emit_mask(arch: GlassArch, probs: torch.Tensor) -> torch.Tensor:
    """Host-fetch representation of mask probabilities (TPU.MASK_FETCH_DTYPE)."""
    if arch.mask_fetch_dtype == "uint8":
        return torch.round(probs * 255.0).to(torch.uint8)
    if arch.mask_fetch_dtype not in ("float32", "float16"):
        raise ValueError(
            f"TPU.MASK_FETCH_DTYPE={arch.mask_fetch_dtype!r} is not supported: "
            "expected one of 'float32', 'float16', 'uint8'"
        )
    return probs.to(_DTYPES[arch.mask_fetch_dtype])


def emit_text(arch: GlassArch, probs: torch.Tensor) -> dict:
    """Recognizer output for the host: argmax ids + max probs ("topk"), or
    the full distributions ("probs")."""
    if arch.text_emit == "topk":
        return {
            "text_ids": torch.argmax(probs, dim=-1).to(torch.int32),
            "text_step_scores": torch.amax(probs, dim=-1),
        }
    return {"text_probs": probs}


def glass_detect_batch(model: GlassRCNN, images: torch.Tensor, image_sizes):
    """Backbone, RPN, box head and NMS over a batch of padded images.

    images: (B, H_pad, W_pad, 3) raw BGR images (uint8 or float), contents
        at the top left, on the model's device.
    image_sizes: as ``rpn_proposals_batch``.

    Returns the detection fields (boxes, scores, classes, orientations,
    valid), each (B, D, ...), the FPN features, the normalized images and
    the packed box pyramid; the features and the pyramid stay on the device
    for the heads, which pool the mask head from the pyramid as it is (no
    second packing)."""
    with trace.span("glass.backbone"):
        norm = preprocess(model, images)
        feats = backbone_features(model, norm)
        pyr = pack_box_pyramid(model, feats)
    det = detect_batch(model, feats, pyr, image_sizes)
    return dict(det._asdict()), feats, norm, pyr


def glass_detect_stage(model: GlassRCNN, image: torch.Tensor, content_hw):
    """Stage 1 of two-stage inference: ``glass_detect_batch`` of one
    (H_pad, W_pad, 3) image with (h, w) content -> detection fields (D, ...),
    features, the (H_pad, W_pad, 3) normalized image, the box pyramid."""
    out, feats, norm, pyr = glass_detect_batch(model, image[None],
                                               (int(content_hw[0]), int(content_hw[1])))
    return {k: v[0] for k, v in out.items()}, feats, norm[0], pyr


def glass_heads_batch(model: GlassRCNN, feats, norm: torch.Tensor, pyr: PackedPyramid,
                      boxes: torch.Tensor, classes: torch.Tensor, raw_images=None) -> dict:
    """The recognizer (text fields, ``emit_text``) and, with MASK_INFERENCE,
    the mask head over a batch: boxes (B, D, 5), classes (B, D) -> fields
    (B, D, ...).  ``raw_images``: the (B, H, W, 3) uint8 images, cropped
    with the normalization folded in."""
    arch = model.arch
    out = {}
    if arch.recognizer_on:
        with trace.span("glass.recognizer"):
            probs = recognize_batch(model, feats, norm, boxes, raw_images=raw_images)
            out.update(emit_text(arch, probs))
    if arch.mask_on and arch.mask_inference:
        with trace.span("glass.mask_head"):
            out["mask_probs"] = emit_mask(arch, mask_batch(model, pyr, boxes, classes))
    return out


def glass_heads_stage(model: GlassRCNN, feats, norm: torch.Tensor, pyr: PackedPyramid,
                      boxes: torch.Tensor, classes=None, raw_image=None) -> dict:
    """Stage 2: ``glass_heads_batch`` of one image on a (R, 5) box set;
    ``classes`` None is class 0 for every row (the two-stage and
    given-boxes paths).  ``raw_image``: the (H, W, 3) uint8 image."""
    if classes is None:
        classes = torch.zeros((boxes.shape[0],), dtype=torch.int32, device=boxes.device)
    out = glass_heads_batch(model, feats, norm[None], pyr, boxes[None], classes[None],
                            None if raw_image is None else raw_image[None])
    return {k: v[0] for k, v in out.items()}


def _glass_inference(model: GlassRCNN, images: torch.Tensor, image_sizes) -> dict:
    out, feats, norm, pyr = glass_detect_batch(model, images, image_sizes)
    # uint8 images + f32 compute: crop the raw images with the normalization
    # folded in (exact); under bf16 the crops are bf16 anyway, so crop the
    # normalized images.
    use_raw = images.dtype == torch.uint8 and model.arch.torch_dtype == torch.float32
    out.update(glass_heads_batch(model, feats, norm, pyr, out["boxes"], out["classes"],
                                 raw_images=images if use_raw else None))
    return out


def glass_inference_single(model: GlassRCNN, image: torch.Tensor, content_hw) -> dict:
    """Full single-image inference: the batch program on one image.

    image: (H_pad, W_pad, 3) raw BGR image (uint8 or float), content at the
        top left, on the model's device.
    content_hw: (h, w) ints, the content extent.

    Returns fixed-shape fields: boxes (D, 5), scores (D,), classes (D,),
    orientations (D, 2), valid (D,), text fields (``emit_text``) and
    mask_probs (D, 28, 28) when MASK_INFERENCE is on.

    Each stage runs under a ``utils.trace`` span (``glass.backbone``,
    ``glass.rpn``, ``glass.box_head``, ``glass.recognizer``,
    ``glass.mask_head``), so a ``torch.profiler`` trace attributes device
    kernels to stages.
    """
    out = _glass_inference(model, image[None], (int(content_hw[0]), int(content_hw[1])))
    return {k: v[0] for k, v in out.items()}


def glass_inference_batch(model: GlassRCNN, images: torch.Tensor, hws) -> dict:
    """One program over a batch (``TPU.SERVE_BATCH_MODE="vmap"``).

    images: (B, H_pad, W_pad, 3) raw BGR images (uint8 or float), contents
        at the top left, on the model's device.
    hws: (B, 2) content sizes (h, w): ints on the host, or a tensor.

    Returns the fields of ``glass_inference_single`` stacked, (B, D, ...).
    """
    return _glass_inference(model, images, torch.as_tensor(hws, dtype=torch.float32,
                                                           device=images.device))
