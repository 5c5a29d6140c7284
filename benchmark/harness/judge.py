"""The comparison that decides ``correct``: what the timed path produced,
judged against the plain reference (``benchmark/reference``) at float32
with TF32 off, stage by stage.

Serving (``judge_served``), for each compared image, from the raw scene:

* ``fpn_rel``: the FPN levels the program computed against the
  reference's, worst level's relative L2 distance;
* ``rpn_rel``: the RPN head's objectness logits and deltas (the inputs of
  the proposal selection) against the reference's head on its own
  features, relative L2, the worse of the two;
* ``proposals_off``: the reference's proposal selection (top-k, decoding,
  clipping, rotated NMS) run on the program's own RPN outputs, against the
  program's proposals: program rows with no reference row within 1e-3 px,
  deg and score, plus the difference in their counts;
* ``box_rel``: the box head's class logits, deltas and orientation logits
  at the program's proposals, on the reference's features, relative L2;
* ``detections_off``: the reference's detection stage (softmax, box
  decoding, clipping, rotated NMS, top-k) run on the program's box-head
  outputs, against the program's detections, counted as above;
* ``text_gap``: the recognizer at the program's detections, teacher-forced
  with the program's words: the widest gap, in log-probability, by which a
  word character the program emitted lies below the reference's best at
  that step;
  a step the program zeroed (the decoder's break) where the characters it
  emitted call for none, or the reverse, reads infinite;
* ``text_prob_err``: the widest gap between the probability the program
  gives an emitted character and the reference's (reported, not compared:
  the float8 control reads under three times the program's, 0.054-0.090
  against 0.021-0.023);
* ``mask_err``: the mask head's probabilities at the program's detections,
  widest gap;
* ``post_off``: the returned instances against the reference's host stage
  (resize back, filters, merges, polygons, text threshold) run on the
  program's raw fields: rows that differ beyond 1e-4, plus the difference
  in their counts.

Where a stage takes the program's outputs as its input (proposals, the
box head's outputs, the detections, the raw fields), the reference follows
the program: the stage is a discrete choice that rounding may turn, and is
judged on its own against the same inputs.  Every other stage starts from
the raw scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.glass.models import glass_rcnn as R
from ..reference.glass.models import rpn as R_rpn
from ..reference.glass.models.box_head import fast_rcnn_inference_batch
from ..reference.glass.ops.boxes import apply_deltas
from ..reference.glass.ops.nms_rotated import NEG_INF
from ..reference.glass.ops.roi_align_rotated import multilevel_pool

SERVE_NUMBERS = ("fpn_rel", "rpn_rel", "proposals_off", "box_rel", "detections_off", "text_gap",
                 "text_prob_err", "mask_err", "post_off")
BOX_TOL, SCORE_TOL, POST_TOL = 1e-3, 1e-5, 1e-4


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double().flatten(), ref.double().flatten()
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref).clamp(min=1e-30))


def unmatched(got_rows: torch.Tensor, ref_rows: torch.Tensor, tol) -> int:
    """Rows of ``got`` with no row of ``ref`` within ``tol`` in every column
    (order does not matter), plus the difference in the counts."""
    if got_rows.shape[0] == 0 or ref_rows.shape[0] == 0:
        return max(got_rows.shape[0], ref_rows.shape[0])
    tol = torch.as_tensor(tol, dtype=torch.float64)
    diff = (got_rows.double()[:, None, :] - ref_rows.double()[None, :, :]).abs()
    ok = torch.all(diff <= tol, dim=-1).any(dim=1)
    return int((~ok).sum()) + abs(got_rows.shape[0] - ref_rows.shape[0])


def rows(boxes, scores, valid):
    v = valid.bool()
    return torch.cat([boxes[v].double(), scores[v].double()[:, None]], dim=1)


def angle_free(rows):
    """Angles compared modulo 360."""
    rows = rows.clone()
    rows[:, 4] = torch.remainder(rows[:, 4] + 180.0, 360.0) - 180.0
    return rows


def same(a, b) -> bool:
    """Two field values equal within ``POST_TOL`` (nested sequences,
    arrays, None)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind in "biuf" and b.dtype.kind in "biuf":
        return bool(np.allclose(a.astype(np.float64), b.astype(np.float64), atol=POST_TOL, rtol=0))
    return bool(np.array_equal(a, b))


def instances_off(got, ref) -> int:
    """Rows of two post-processed instance sets that differ beyond
    ``POST_TOL`` in any field, plus the difference in their counts."""
    n, m = len(got), len(ref)
    fg, fr = got.get_fields(), ref.get_fields()
    if set(fg) != set(fr):
        return max(n, m, 1)
    return abs(n - m) + sum(1 for i in range(min(n, m)) if not all(same(fg[k][i], fr[k][i]) for k in fg))


def judge_served(ref_runner, path: str, image: np.ndarray, cap: dict, returned) -> dict:
    """The numbers of one compared image.  ``cap``: what ``Capture`` kept
    of its model program; ``returned``: the instances the timed path
    returned for it."""
    model, dev = ref_runner.model, ref_runner.device
    arch = model.arch
    if path == "eval":
        resized, orig_hw = ref_runner.eval_resize(image)
    else:
        resized, ratio = ref_runner.serve_resize(image)
    hw = resized.shape[:2]
    x = ref_runner.padded(resized)
    out_p = {k: torch.as_tensor(v) for k, v in cap["out"].items()}
    num = {}
    with torch.no_grad():
        norm = R.preprocess(model, x)
        feats = R.backbone_features(model, norm[None])
        num["fpn_rel"] = max(rel_l2(cap["feats"][k].float(), feats[k].cpu()) for k in feats)

        # RPN head on the reference's features, masked as the program masks
        p_logits, p_deltas, p_sizes = cap["select_in"]
        levels = [feats[f] for f in arch.rpn_in_features]
        logits, deltas = model.proposal_generator.rpn_head(levels)
        lg_rel = []
        for lp, lr in zip(p_logits, logits):
            lp = lp.float()
            inside = lp > NEG_INF / 2  # anchors beyond the content are masked to NEG_INF
            lg_rel.append((lp[inside], lr.cpu().float()[inside]))
        num["rpn_rel"] = max(
            rel_l2(torch.cat([a for a, _ in lg_rel]), torch.cat([b for _, b in lg_rel])),
            rel_l2(torch.cat([d.float().flatten() for d in p_deltas]),
                   torch.cat([d.cpu().float().flatten() for d in deltas])))

        # the selection, on the program's own RPN outputs
        anchors = [model.anchors(i, f.shape[2], f.shape[3], dev) for i, f in enumerate(levels)]
        sizes = p_sizes.to(dev) if torch.is_tensor(p_sizes) else p_sizes
        sel = R_rpn.select_proposals_batch(
            [lp.to(dev) for lp in p_logits], [d.to(dev) for d in p_deltas], anchors, sizes,
            arch.rpn_bbox_weights, arch.rpn_pre_nms_topk, arch.rpn_post_nms_topk, arch.rpn_nms_thresh)
        pb, ps, pv = cap["select_out"]
        tol = [BOX_TOL] * 5 + [SCORE_TOL]
        num["proposals_off"] = unmatched(angle_free(rows(pb[0], ps[0], pv[0])),
                                         angle_free(rows(sel[0][0].cpu(), sel[1][0].cpu(), sel[2][0].cpu())), tol)

        # box head at the program's proposals
        pyr = R.pack_box_pyramid(model, feats)
        rois = pb[0].to(dev).float()
        pooled = multilevel_pool(pyr, R._min_level(model), rois,
                                 (arch.box_pooler_resolution, arch.box_pooler_resolution),
                                 arch.box_pooler_sampling_ratio, arch.pool_max_sampling_ratio,
                                 arch.pool_bulk_sampling_ratio, arch.pool_large_roi_budget,
                                 rois_per_image=rois.shape[0])
        ref_pred = model.roi_heads.box_predictor(model.roi_heads.box_head(pooled).float())
        num["box_rel"] = max(rel_l2(a.float(), b.cpu()) for a, b in zip(cap["predictor"], ref_pred)
                             if a is not None)

        # detections, on the program's box-head outputs
        c_scores, c_deltas, c_orient = (None if t is None else t.to(dev).float() for t in cap["predictor"])
        boxes = apply_deltas(c_deltas, rois, arch.box_bbox_weights)
        det = fast_rcnn_inference_batch(
            boxes[None], torch.softmax(c_scores, dim=-1)[None],
            None if c_orient is None else c_orient[None], pv.to(dev), sizes, arch.score_thresh,
            arch.nms_thresh, arch.detections_per_image,
            arch.apply_orientation_to_boxes and arch.orientation_on)
        got = torch.cat([rows(out_p["boxes"], out_p["scores"], out_p["valid"]),
                         out_p["orientations"][out_p["valid"].bool()].double()], dim=1)
        ref = torch.cat([rows(det.boxes[0].cpu(), det.scores[0].cpu(), det.valid[0].cpu()),
                         det.orientations[0].cpu()[det.valid[0].cpu()].double()], dim=1)
        num["detections_off"] = unmatched(angle_free(got), angle_free(ref), tol + [0.0, SCORE_TOL])

        # recognizer at the program's detections, teacher-forced
        d_boxes = out_p["boxes"].to(dev).float()
        raw = x if x.dtype == torch.uint8 else None
        enc = R.recognizer_encode(model, feats, norm, d_boxes, raw_image=raw).float()
        num["text_gap"], num["text_prob_err"] = _teacher_forced(
            model.roi_heads.recognizer_head.aster, enc, out_p["text_ids"].to(dev).long(),
            out_p["text_step_scores"].to(dev).float())

        if "mask_probs" in out_p:
            probs = R.mask_batch(model, pyr, d_boxes[None], out_p["classes"].to(dev)[None])[0]
            v = out_p["valid"].bool()
            num["mask_err"] = float((out_p["mask_probs"].float()[v] - probs.cpu()[v]).abs().max()) \
                if v.any() else 0.0
        else:
            num["mask_err"] = 0.0

    # the host stage on the program's raw fields
    raw_out = {k: np.asarray(v) for k, v in cap["out"].items()}
    if path == "eval":
        ref_ret = ref_runner.eval_post(raw_out, hw, orig_hw)
    else:
        ref_ret = ref_runner.serve_post(raw_out, hw, ratio, image.shape[:2])
    num["post_off"] = instances_off(returned, ref_ret)
    num["words"] = len(returned)
    return num


def _teacher_forced(decoder, x, ids, scores, eos: int = 0):
    """(widest log-prob gap of an emitted character below the reference's
    best, widest probability gap) of one image's rows, the decoder fed the
    program's own characters.  Steps after the program's break (every row
    has emitted eos) are zero in the program and not compared; a zero step
    before it, or a live one after it, makes the gap infinite."""
    n, steps = ids.shape
    sdim = decoder.gru.weight_hh_l0.shape[1]
    xe = decoder.attention_unit.xEmbed
    from ..reference.glass.models import layers as L

    x_proj = L.linear(x, xe.weight, xe.bias)
    state = torch.zeros((n, sdim), dtype=x.dtype, device=x.device)
    y_prev = torch.zeros((n,), dtype=torch.int64, device=x.device)
    done = torch.zeros((n,), dtype=torch.bool, device=x.device)
    gap = err = 0.0
    for t in range(steps):
        if bool(done.all()):
            if bool((scores[:, t] != 0).any()):
                gap = math.inf
            continue
        logits, state = decoder.step(x, x_proj, state, y_prev)
        lp = torch.log_softmax(logits.double(), dim=-1)
        served = ids[:, t]
        mine = lp.gather(1, served[:, None])[:, 0]
        gap = max(gap, float((lp.max(dim=-1).values - mine).max()))
        if bool((scores[:, t] == 0).any()):
            gap = math.inf
        err = max(err, float((scores[:, t].double() - mine.exp()).abs().max()))
        y_prev = served
        done = done | (served == eos)
    return gap, err


def missing() -> dict:
    """The numbers of a compared answer that the timed path never produced
    (or whose stages it never ran): every one fails."""
    return {k: math.inf for k in SERVE_NUMBERS}


def worst(readings: list) -> dict:
    """The worst reading of each number over the compared answers."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if isinstance(v, (int, float)):
                out[k] = max(out.get(k, -math.inf), v)
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, lines): each compared number beside its limit."""
    lines, ok = [], True
    for k in limits:
        v = numbers.get(k)
        good = v is not None and v <= limits[k] and not (isinstance(v, float) and math.isnan(v))
        ok &= good
        lines.append(f"{k} {v!r} limit {limits[k]!r} {'ok' if good else 'FAIL'}")
    return ok, lines

