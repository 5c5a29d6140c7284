"""The training path's parts against glass_tpu, on the CPU at small sizes.

Training-mode batch norm, the stem (the port's plain 7x7/2 against
glass_tpu's ``s2d4`` training stem), ``get_deltas`` and the losses, the
exact anchor matcher (labels and matched indices against glass_tpu's scan
*and* tiled matchers), the samplers on the same uniform draws, mask targets,
the teacher-forced decode, the optimizer's groups, schedule and steps
against optax, the max-pool tie rule, and the options that raise.

Tolerances: 1e-5 abs where both sides run the same f32 operations in the
same order (losses, deltas, decode), 1e-4 where a reduction or a
convolution reorders sums (BN, the stem, whose s2d4 form is a different
contraction; glass_tpu's own tests/test_s2d_stem.py bounds), 1e-6 relative
on three optimizer steps; equality for every discrete result (labels,
indices, masks, the tie rule).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.models import layers as JL
from glass_tpu.models.context import Ctx
from glass_tpu.models.recognizer import aster_decode_train as j_decode_train
from glass_tpu.models.resnet import _stem_conv_s2d4
from glass_tpu.ops.boxes import get_deltas as j_get_deltas
from glass_tpu.train import losses as JLS
from glass_tpu.train import matcher as JM
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict
from glass_tpu.train.optimizer import _is_norm_param, _trainable
from glass_tpu.train.optimizer import build_optimizer as j_build_optimizer
from glass_tpu.train.targets import mask_targets_for_proposals as j_mask_targets

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.models import layers as L
from glass_tpu_torch.models import rpn as rpn_mod
from glass_tpu_torch.models.context import BatchNorm2d, conv_norm
from glass_tpu_torch.models.glass_rcnn import _check_ported
from glass_tpu_torch.models.recognizer import DecoderUnit, aster_decode_train
from glass_tpu_torch.ops.boxes import get_deltas
from glass_tpu_torch.train import losses as LS
from glass_tpu_torch.train import matcher as M
from glass_tpu_torch.train.optimizer import GlassOptimizer, is_norm_param
from glass_tpu_torch.train.targets import mask_targets_for_proposals
from glass_tpu_torch.train.train_step import check_trainable
from glass_tpu_torch.weights import _flatten, _torch_name

torch.set_num_threads(2)
ICDAR15 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                       "glass_finetune_icdar15.yaml")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


# ---------------------------------------------------------------------------
# batch norm and the stem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batch_norm_matches(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 6, 8) * 2 + 1).astype(np.float32)  # NHWC, padding rows included
    x[:, -1] = 0.0
    p = {"weight": rng.rand(8).astype(np.float32) + 0.5, "bias": rng.randn(8).astype(np.float32),
         "running_mean": rng.randn(8).astype(np.float32), "running_var": rng.rand(8).astype(np.float32) + 0.5}
    out, new = JL.batch_norm(jnp.asarray(x, dtype), {k: jnp.asarray(v) for k, v in p.items()}, train=True)
    bn = BatchNorm2d(8).train()
    with torch.no_grad():
        for k, v in p.items():
            getattr(bn, k).copy_(t(v))
    got = bn(t(x.transpose(0, 3, 1, 2)).to(getattr(torch, dtype)))
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * 8
    np.testing.assert_allclose(nhwc(got.float()), np.asarray(out, np.float32), atol=tol, rtol=tol)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(new[k]), rtol=1e-5, atol=1e-6)


def test_eval_mode_batch_norm_is_unchanged_and_emits_no_update():
    bn = BatchNorm2d(4).eval()
    x = torch.randn(2, 4, 3, 3)
    before = bn.running_mean.clone()
    torch.testing.assert_close(bn(x), L.batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var))
    assert torch.equal(bn.running_mean, before)


def test_plain_stem_matches_s2d4_training_stem():
    """The port's plain 7x7/2 stem conv + train BN + ReLU against glass_tpu's
    s2d4 reparametrization: outputs, BN updates and the weight gradient."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    stem = conv_norm(3, 64, 7, 2, 3, relu=True).train()
    with torch.no_grad():
        stem.weight.copy_(t(rng.randn(64, 3, 7, 7).astype(np.float32) * 0.1))
        stem.norm.weight.copy_(t(rng.rand(64).astype(np.float32) + 0.5))
    params = {"weight": jnp.asarray(stem.weight.detach().numpy().transpose(2, 3, 1, 0)),
              "norm": {k: jnp.asarray(getattr(stem.norm, k).detach().numpy())
                       for k in ("weight", "bias", "running_mean", "running_var")}}
    ct = rng.randn(2, 16, 24, 64).astype(np.float32)

    def j_loss(w):
        ctx = Ctx(train=True)
        out = _stem_conv_s2d4(ctx, jnp.asarray(x), dict(params, weight=w), "stem.conv1")
        return jnp.vdot(jnp.asarray(ct), out), (out, ctx.bn_updates)

    (_, (want, bn)), w_grad = jax.value_and_grad(j_loss, has_aux=True)(params["weight"])
    got = stem(t(x.transpose(0, 3, 1, 2)))
    (got * t(ct.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(stem.norm, k).numpy(), np.asarray(bn["stem.conv1.norm"][k]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(stem.weight.grad.numpy().transpose(2, 3, 1, 0), np.asarray(w_grad),
                               atol=2e-3, rtol=1e-4)


def test_frozen_stages_take_no_gradient_and_no_update():
    arch = GlassArch(rpn_pre_nms_topk=32, rpn_post_nms_topk=8, detections_per_image=4, freeze_at=2)
    model = GlassRCNN(arch).train()
    bu = model.backbone.bottom_up
    assert not bu.stem.training and not bu.res2.training and bu.res3.training
    before = bu.res2[0].conv1.norm.running_mean.clone()
    feats = model.backbone(torch.randn(1, 3, 64, 64))
    feats["p2"].sum().backward()
    assert bu.res2[0].conv1.weight.grad is None and bu.stem.conv1.weight.grad is None
    assert bu.res3[0].conv1.weight.grad is not None
    assert torch.equal(bu.res2[0].conv1.norm.running_mean, before)


# ---------------------------------------------------------------------------
# deltas and losses
# ---------------------------------------------------------------------------


def _boxes(rng, n):
    return np.stack([rng.uniform(0, 200, n), rng.uniform(0, 100, n), rng.uniform(4, 90, n),
                     rng.uniform(3, 40, n), rng.uniform(-180, 180, n)], 1).astype(np.float32)


def test_get_deltas_matches():
    rng = np.random.RandomState(2)
    src, tgt = _boxes(rng, 50), _boxes(rng, 50)
    for w in ((1.0, 1.0, 1.0, 1.0, 2.0), (10.0, 10.0, 5.0, 5.0, 10.0)):
        np.testing.assert_allclose(get_deltas(t(src), t(tgt), w).numpy(),
                                   np.asarray(j_get_deltas(jnp.asarray(src), jnp.asarray(tgt), w)),
                                   atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("name,beta", [("smooth_l1", 0.0), ("smooth_l1", 0.11), ("sine_square_loss", 1.0),
                                       ("sine_loss", 0.11), ("cosine_loss", 1.0)])
def test_box_regression_losses_match(name, beta):
    rng = np.random.RandomState(3)
    pred, gt = rng.randn(40, 5).astype(np.float32), rng.randn(40, 5).astype(np.float32)
    w = (1.0, 1.0, 1.0, 1.0, 2.0)
    p = t(pred).requires_grad_(True)
    got = LS.BOX_REG_LOSSES[name](p, t(gt), beta, w)
    want, vjp = jax.vjp(lambda a: JLS.BOX_REG_LOSSES[name](a, jnp.asarray(gt), beta, w), jnp.asarray(pred))
    ct = rng.randn(40, 5).astype(np.float32)
    got.backward(t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=1e-5)


def test_classification_losses_match():
    rng = np.random.RandomState(4)
    logits = rng.randn(30, 5).astype(np.float32) * 3
    labels = rng.randint(0, 5, 30)
    mask = rng.rand(30) > 0.3
    np.testing.assert_allclose(
        float(LS.masked_cross_entropy(t(logits), t(labels), t(mask))),
        float(JLS.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))), rtol=1e-6)
    bl = rng.randn(6, 7, 7).astype(np.float32) * 4
    bl[0, 0, :3] = 0.0  # the tie of max(x, 0)
    tg = (rng.rand(6, 7, 7) > 0.5).astype(np.float32)
    bm = rng.rand(6, 7, 7) > 0.2
    x = t(bl).requires_grad_(True)
    got = LS.masked_bce_with_logits(x, t(tg), t(bm))
    got.backward()
    want, g = jax.value_and_grad(lambda a: JLS.masked_bce_with_logits(a, jnp.asarray(tg), jnp.asarray(bm)))(
        jnp.asarray(bl))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=1e-7)
    dl = rng.randn(4, 6, 9).astype(np.float32)
    dt = rng.randint(0, 9, (4, 7))
    dt[:, 3:] = 0  # ignore_index 0
    wm = np.array([True, False, True, True])
    np.testing.assert_allclose(
        float(LS.decoder_cross_entropy(t(dl), t(dt), t(wm))),
        float(JLS.decoder_cross_entropy(jnp.asarray(dl), jnp.asarray(dt), jnp.asarray(wm))), rtol=1e-6)
    # no valid row: 0, not NaN
    assert float(LS.masked_cross_entropy(t(logits), t(labels), torch.zeros(30, dtype=torch.bool))) == 0.0


# ---------------------------------------------------------------------------
# matching and sampling
# ---------------------------------------------------------------------------


def _anchors_and_specs(h, w, arch=GlassArch()):
    anchors, specs = [], []
    for i, s in enumerate((4, 8, 16, 32, 64)):
        gh, gw = -(-h // s), -(-w // s)
        cell = rpn_mod.generate_cell_anchors(arch.anchor_sizes[i], arch.anchor_aspects, arch.anchor_angles)
        anchors.append(rpn_mod.generate_anchors_for_level(gh, gw, s, cell, arch.anchor_offset))
        specs.append((gh, gw, s, cell, arch.anchor_offset))
    return np.concatenate(anchors), tuple(specs)


def _gts(rng, h, w, g=12, n_valid=9):
    gts = np.stack([rng.uniform(10, w - 10, g), rng.uniform(10, h - 10, g), rng.uniform(12, 120, g),
                    rng.uniform(6, 30, g), rng.uniform(-60, 60, g)], 1).astype(np.float32)
    gts[0] = (40.0, 30.0, 3.0, 2.0, 10.0)        # weak: only the rescue matches it
    gts[1] = (w + 300.0, 20.0, 30.0, 10.0, 0.0)  # far outside every anchor
    gts[2] = (64.0, 48.0, 64.0, 16.0, 0.0)       # on an anchor (IoU 1)
    valid = np.arange(g) < n_valid
    gts[~valid] = (0, 0, 1, 1, 0)
    return gts, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_labels_equal_glass_tpu_scan_and_tiled(seed):
    rng = np.random.RandomState(seed)
    h, w = 96, 160
    anchors, specs = _anchors_and_specs(h, w)
    gts, valid = _gts(rng, h, w)
    labels, matched, diag = M.rpn_label_anchors(t(gts), t(valid), t(anchors))
    scan = jax.jit(lambda g, v, a: JM.rpn_label_anchors(g, v, a, k=16384))
    tiled = jax.jit(lambda g, v: JM.rpn_label_anchors_tiled(g, v, specs, k=16384, tile_cap=512))
    for j_labels, j_matched, j_diag in (scan(gts, valid, anchors), tiled(gts, valid)):
        assert float(j_diag["matcher_pool_dropped"]) == 0.0
        assert float(j_diag.get("matcher_tile_dropped", 0.0)) == 0.0  # the tiled pools did not overflow
        np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
        np.testing.assert_array_equal(matched.numpy(), np.asarray(j_matched))
    assert float(diag["matcher_pool_dropped"]) == 0.0
    lab = labels.numpy()
    assert (lab == 1).sum() > 0 and (lab == -1).sum() > 0 and (lab == 0).sum() > 0


def test_matcher_assign_matches():
    rng = np.random.RandomState(5)
    q = rng.rand(6, 40).astype(np.float32)
    q[:, :5] = 0.0
    q[2, 7] = q[4, 7] = 0.9  # a tie: the first maximum wins
    for kw in (dict(thresholds=(0.5,), labels=(0, 1)),
               dict(thresholds=(0.3, 0.7), labels=(0, -1, 1), allow_low_quality=True)):
        idx, lab = M.matcher_assign(t(q), **kw)
        j_idx, j_lab = JM.matcher_assign(jnp.asarray(q), **kw)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab))


def test_samplers_pick_what_glass_tpu_picks():
    """The same uniform draws (glass_tpu's key splits) give the same masks
    and index sets, counts capped as d2's subsample_labels."""
    rng = np.random.RandomState(6)
    labels = rng.choice([-1, 0, 1], 3000, p=[0.1, 0.85, 0.05]).astype(np.int32)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    u1, u2 = (t(np.array(jax.random.uniform(k, (3000,)))) for k in (k1, k2))
    for num, frac in ((64, 0.5), (512, 0.25), (4000, 0.25)):
        pos, neg = M.subsample_labels(t(labels), num, frac, u1, u2)
        j_pos, j_neg = JM.subsample_labels(key, jnp.asarray(labels), num, frac)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
        np.testing.assert_array_equal(neg.numpy(), np.asarray(j_neg))
        assert int(pos.sum()) == min(int((labels == 1).sum()), int(num * frac))
        assert int(neg.sum()) == min(int((labels == 0).sum()), num - int(pos.sum()))
        got = M.subsample_labels_idx(t(labels), num, frac, u1, u2)
        want = JM.subsample_labels_idx(key, jnp.asarray(labels), num, frac)
        for (gi, gv), (wi, wv) in ((got[:2], want[:2]), (got[2:], want[2:])):
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
            np.testing.assert_array_equal(gi.numpy()[gv.numpy()], np.asarray(wi)[np.asarray(wv)])


def test_select_topk_mask_order():
    """Selected entries by descending priority, then the lowest unselected
    indices (``lax.top_k``'s -inf order), capacity beyond n padded."""
    mask = torch.tensor([False, True, False, True, True])
    idx, valid = M.select_topk_mask(mask, 7, torch.tensor([0.5, 0.2, 0.9, 0.7, 0.7]))
    assert idx.tolist() == [3, 4, 1, 0, 2, 4, 4] and valid.tolist() == [True] * 3 + [False] * 4


# ---------------------------------------------------------------------------
# mask targets and the teacher-forced decode
# ---------------------------------------------------------------------------


def test_mask_targets_match():
    rng = np.random.RandomState(7)
    g, k, p = 5, 10, 24
    polys = np.zeros((g, k, 2), np.float32)
    nv = rng.randint(3, k + 1, g).astype(np.int32)
    for i in range(g):
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv[i]))
        r = rng.uniform(10, 30, nv[i])
        polys[i, :nv[i]] = np.stack([60 + r * np.cos(ang), 40 + r * np.sin(ang)], 1)
    gidx = rng.randint(0, g, p)
    boxes = np.stack([rng.uniform(40, 80, p), rng.uniform(25, 55, p), rng.uniform(10, 60, p),
                      rng.uniform(8, 40, p), rng.uniform(-90, 90, p)], 1).astype(np.float32)
    got = mask_targets_for_proposals(t(polys), t(nv), t(gidx), t(boxes), 28).numpy()
    want = np.asarray(j_mask_targets(jnp.asarray(polys), jnp.asarray(nv), jnp.asarray(gidx),
                                     jnp.asarray(boxes), 28))
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, want)


def test_aster_decode_train_matches():
    torch.manual_seed(0)
    dec = DecoderUnit(32, 32, 11, 32)
    params = convert_torch_state_dict({k: v.numpy() for k, v in dec.state_dict().items()})
    rng = np.random.RandomState(8)
    x = rng.randn(3, 10, 32).astype(np.float32)
    targets = rng.randint(0, 11, (3, 7)).astype(np.int32)
    xt = t(x).requires_grad_(True)
    got = aster_decode_train(dec, xt, t(targets), 6)
    want, vjp = jax.vjp(lambda a: j_decode_train(params, a, jnp.asarray(targets), 6), jnp.asarray(x))
    ct = rng.randn(*got.shape).astype(np.float32)
    got.backward(t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=1e-5)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_optimizer_groups_follow_glass_tpu_naming():
    model = GlassRCNN(GlassArch())
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = _walk_rename(convert_torch_state_dict(sd))
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: "frozen" if not _trainable(path) else ("norm" if _is_norm_param(path) else "default"),
        tree)
    j_label = {_torch_name(path): lab for path, lab in _flatten(labels)}
    params = dict(model.named_parameters())
    for name, lab in j_label.items():
        if lab == "frozen":
            assert name not in params, name  # BN statistics are buffers
        else:
            assert lab == ("norm" if is_norm_param(name) else "default"), name
    assert set(params) == {n for n, lab in j_label.items() if lab != "frozen"}
    assert is_norm_param("roi_heads.fusion_net.channel_add_conv.1.weight")
    assert not is_norm_param("roi_heads.hybrid_net.ConvNet.layer1.0.downsample.1.weight")


def _tree(flat):
    out = {}
    for name, v in flat.items():
        node = out
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


class _Named(nn.Module):
    """Parameters under dotted names (a module tree built from them)."""

    def __init__(self, arrays):
        super().__init__()
        for name, v in arrays.items():
            *path, leaf = name.split(".")
            mod = self
            for p in path:
                if not hasattr(mod, p):
                    mod.add_module(p, nn.Module())
                mod = getattr(mod, p)
            mod.register_parameter(leaf, nn.Parameter(t(v.copy())))


SOLVERS = {
    "default": [],
    "nesterov, clip value": ["SOLVER.NESTEROV", "True", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                             "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "value", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.5"],
    "warmup, steps, clip norm": ["SOLVER.WARMUP_ITERS", "2", "SOLVER.WARMUP_FACTOR", "0.1", "SOLVER.STEPS", "(1, 2)",
                                 "SOLVER.GAMMA", "0.5", "SOLVER.WEIGHT_DECAY_NORM", "0.001",
                                 "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                                 "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "1.0"],
}


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_three_sgd_steps_match_optax(solver):
    rng = np.random.RandomState(9)
    names = ["backbone.stem.conv1.weight", "backbone.stem.conv1.norm.weight", "roi_heads.hybrid_net.bn1.bias",
             "roi_heads.fusion_net.channel_add_conv.1.weight", "roi_heads.fusion_net.channel_add_conv.0.weight",
             "roi_heads.hybrid_net.layer1.0.downsample.1.weight", "roi_heads.box_head.fc1.bias"]
    arrays = {n: rng.randn(4, 3).astype(np.float32) for n in names}
    opts = SOLVERS[solver]
    jcfg, cfg = j_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(arrays))
    tx, schedule = j_build_optimizer(jcfg, params)
    state = tx.init(params)
    module = _Named(arrays)
    opt = GlassOptimizer(cfg, module)
    for step in range(3):
        grads = {n: rng.randn(4, 3).astype(np.float32) * 2 for n in names}
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(grads)), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for n, p in module.named_parameters():
            p.grad = t(grads[n].copy())
        opt.step(step)
        np.testing.assert_allclose(opt.schedule(step), float(schedule(step)), rtol=1e-6)
    for path, want in _flatten(jax.device_get(params)):
        got = dict(module.named_parameters())[".".join(path)]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_schedule_matches_glass_tpu():
    from glass_tpu.train.optimizer import warmup_multistep_schedule as j_schedule
    from glass_tpu_torch.train.optimizer import warmup_multistep_schedule

    for method in ("linear", "constant"):
        args = (0.01, [5, 9], 0.6, 4, 0.001, method)
        mine, theirs = warmup_multistep_schedule(*args), j_schedule(*args)
        for count in range(12):
            np.testing.assert_allclose(mine(count), float(theirs(count)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the max-pool tie rule, and the options that raise
# ---------------------------------------------------------------------------


def test_max_pool_backward_routes_ties_to_the_first_maximum():
    rng = np.random.RandomState(10)
    x = rng.randint(0, 3, (2, 9, 11, 4)).astype(np.float32)  # NHWC, many ties
    x[0, :3, :3] = 0.0  # a whole window of zeros (a ReLU's output)
    ct = rng.randint(-3, 4, (2, 5, 6, 4)).astype(np.float32)  # sums of overlapping windows exact
    xt = t(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    out = F.max_pool2d(xt, 3, 2, 1)
    out.backward(t(ct.transpose(0, 3, 1, 2)))
    got = nhwc(xt.grad)
    dense = jax.grad(lambda a: jnp.vdot(jnp.asarray(ct), JL._max_pool2d_densegrad(a, (3, 3), (2, 2), (1, 1))))
    native = jax.grad(lambda a: jnp.vdot(jnp.asarray(ct), JL.max_pool2d(a, 3, 2, 1)))
    np.testing.assert_array_equal(got, np.asarray(dense(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.asarray(native(jnp.asarray(x))))


def test_relu_splits_the_gradient_at_zero_as_glass_tpu():
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    L.relu(x).sum().backward()
    want = jax.grad(lambda a: jnp.maximum(a, 0).sum())(jnp.array([-1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("opts,match", [
    (["TPU.TRAIN_LOOP_STEPS", "2"], "TRAIN_LOOP_STEPS"),
    (["TPU.REMAT_BACKBONE", "True"], "REMAT_BACKBONE"),
])
def test_unported_training_options_raise(opts, match):
    """Both options are ported (they raised until then): the trainer's
    check accepts each, and it reaches the code that runs it
    (tests/test_torch_remat.py and tests/test_torch_train_loop.py hold them
    to glass_tpu)."""
    from glass_tpu_torch.train.trainer import Trainer

    cfg = get_cfg(ICDAR15)
    cfg.merge_from_list(opts)
    check_trainable(cfg)
    if match == "REMAT_BACKBONE":
        assert GlassArch.from_config(cfg).remat_backbone
    else:
        assert Trainer.chunk_len(0, 10, cfg.TPU.TRAIN_LOOP_STEPS, 0, 0, 0) == 2


@pytest.mark.parametrize("kw", [dict(recognizer_decoder="CTC", vocab_size=96), dict(pooler_pad="FeatPadV2")])
def test_ctc_and_featpad_training_raise(kw):
    """CTC and FeatPadV2 training are ported (they raised until then):
    ``_check_ported`` accepts them, and one step of the tiny
    model on the CPU gives finite losses and gradients.
    tests/test_torch_variants_train.py holds the step to glass_tpu."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_train_step import ARCH_KW, TCFG_KW, make_batch
    from test_torch_variants_train import ctc_batch

    from glass_tpu_torch.train.train_step import Priorities, TrainConfig, glass_train_forward
    from glass_tpu_torch.train.trainer import init_weights_

    arch = GlassArch(**ARCH_KW, **kw)
    _check_ported(arch)
    model = init_weights_(GlassRCNN(arch), 0).train()
    batch = ctc_batch() if "recognizer_decoder" in kw else make_batch()
    tb = {k: (v if k == "content_hw" else torch.from_numpy(v)) for k, v in batch.items()}
    total, losses = glass_train_forward(model, TrainConfig(**TCFG_KW), tb, Priorities(0, 0, "cpu"))
    total.backward()
    assert all(np.isfinite(float(v)) for v in losses.values()) and float(losses["loss_decoder"]) > 0
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


def test_match_backend_and_sampler_are_validated():
    from glass_tpu_torch.train.train_step import TrainConfig

    for opts in (["TPU.MATCH_BACKEND", "dense"], ["TPU.RPN_SAMPLER", "topk"],
                 ["TPU.MATCH_BACKEND", "scan", "TPU.RPN_SAMPLER", "pool"]):
        cfg = get_cfg()
        cfg.merge_from_list(opts)
        with pytest.raises(ValueError):
            TrainConfig.from_config(cfg)
    cfg = get_cfg()
    for backend, sampler in (("tiled", "pool"), ("tiled", "axis"), ("scan", "axis")):
        cfg.merge_from_list(["TPU.MATCH_BACKEND", backend, "TPU.RPN_SAMPLER", sampler])
        assert TrainConfig.from_config(cfg).roi_batch_per_image == 512
