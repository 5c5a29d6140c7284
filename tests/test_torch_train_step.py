"""The port's training forward and step against glass_tpu's, on the CPU.

One seeded model (the port's training init) is converted to glass_tpu's
parameter tree by glass_tpu's own checkpoint converter.  Both sides take the
same numpy batch (two 64x64 images, a padded gt row) and the same random
choices: ``JaxReplay`` is the port's priorities seam fed with the uniform
draws ``glass_train_forward`` derives from its key (``jax.random.split(key,
8)``, then per image, with TPU.MATCH_BACKEND scan and TPU.RPN_SAMPLER
axis), so the port's own top-k code runs on glass_tpu's numbers.

Compared in f32: every loss and diagnostic, every parameter's gradient,
every BN running-statistics update, then one optimizer step.  Discrete
choices (sampled anchors and rois) enter through the losses and gradients:
one different choice moves them far beyond the tolerances.

Tolerances.  Losses: 1e-4 relative (+1e-6).  Gradients, per tensor, in
relative L2 norm: 1e-3 for the heads next to the losses (RPN head,
predictors, mask head, decoder); 5e-2 for every tensor.  That second bound
is the conditioning floor of a randomly initialised deep network at this
size, not slack: a 1e-7 relative perturbation of the weights moves the
port's own backbone and local-CNN gradients by 1-3e-2 in relative L2
(measured), because ReLUs whose input lies within rounding of zero switch
and batch norm over a 2x2 map (res5 of a 64x64 image) amplifies
differences.  A tensor whose gradient is pure rounding noise (largest
magnitude below 1e-6: biases a softmax is invariant to) is held to 1e-6
abs.  BN updates: 1e-4 relative (+1e-5).  The optimizer step: the moved
distance within the gradients' bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.models import GlassArch as JArch
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict
from glass_tpu.train.optimizer import apply_bn_updates, build_optimizer as j_build_optimizer
from glass_tpu.train.train_step import TrainConfig as JTrainConfig
from glass_tpu.train.train_step import glass_train_forward as j_forward

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.ops.boxes import boxes_to_polygons
from glass_tpu_torch.train.optimizer import build_optimizer
from glass_tpu_torch.train.train_step import TrainConfig, glass_train_forward
from glass_tpu_torch.train.trainer import init_weights_
from glass_tpu_torch.weights import state_dict_from_jax_params

torch.set_num_threads(2)
ARCH_KW = dict(rpn_pre_nms_topk=64, rpn_post_nms_topk=16, detections_per_image=8, max_word_len=5,
               compute_dtype="float32")
TCFG_KW = dict(rpn_pre_nms_topk=64, rpn_post_nms_topk=16, roi_batch_per_image=32,
               words_per_image=4, masks_per_image=8)
GRAD_L2_TOL = 5e-2
HEAD_L2_TOL = 1e-3
HEADS = ("proposal_generator.", "roi_heads.box_predictor.", "roi_heads.mask_head.",
         "roi_heads.recognizer_head.decoder.")
_uniform = jax.jit(jax.random.uniform, static_argnums=1)
_split = jax.jit(jax.random.split, static_argnums=1)


class JaxReplay:
    """The port's ``Priorities`` seam replaying glass_train_forward's draws."""

    def __init__(self, key, b):
        keys = _split(key, 8)
        self.per_image = {name: _split(keys[i], b)
                          for i, name in enumerate(("rpn", "roi", "word", "mask"))}

    def uniform(self, site, image, shape):
        group, _, part = site.partition("_")
        k = self.per_image[group][image]
        if group != "mask":  # subsample_labels' (k1, k2); select_words' (k_strat, k_pick)
            k = _split(k, 2)[0 if part in ("pos", "strategy") else 1]
        return torch.from_numpy(np.array(_uniform(k, tuple(shape))))


def make_batch(b=2, h=64, w=64, g=6, k=8, t=5, seed=0):
    rng = np.random.RandomState(seed)
    boxes = np.stack([
        rng.uniform(16, w - 16, (b, g)), rng.uniform(16, h - 16, (b, g)),
        rng.uniform(10, 30, (b, g)), rng.uniform(6, 14, (b, g)), rng.uniform(-45, 45, (b, g)),
    ], axis=-1).astype(np.float32)
    boxes[1, 0, 2:4] = (3.0, 2.0)  # a weak gt: only the low-quality rescue matches it
    text = np.zeros((b, g, t + 2), np.int32)
    for bi in range(b):
        for gi in range(g):
            n = rng.randint(1, t)
            text[bi, gi, 1:1 + n] = rng.randint(2, 90, n)
            text[bi, gi, 1 + n] = 1  # [s]
    polys = np.zeros((b, g, k, 2), np.float32)
    polys[:, :, :4] = boxes_to_polygons(torch.from_numpy(boxes)).numpy()
    valid = np.ones((b, g), bool)
    valid[0, -1] = False  # a padded gt row
    boxes[0, -1] = (0, 0, 1, 1, 0)
    return {
        "images": rng.rand(b, h, w, 3).astype(np.float32) * 255,
        "content_hw": np.array([[h, w], [h - 8, w - 4]], np.int32)[:b],
        "gt_boxes": boxes, "gt_valid": valid,
        "gt_classes": np.zeros((b, g), np.int32),
        "gt_orientation": rng.randint(0, 4, (b, g)).astype(np.int32),
        "gt_text": text, "gt_polygons": polys,
        "gt_poly_nv": np.full((b, g), 4, np.int32),
    }


@pytest.fixture(scope="module")
def run():
    batch = make_batch()
    key = jax.random.PRNGKey(5)
    model = init_weights_(GlassRCNN(GlassArch(**ARCH_KW)), 0)
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in sd0.items()}))
    jarch, jtcfg = JArch(**ARCH_KW), JTrainConfig(**TCFG_KW, match_topk=16384)

    def loss_fn(p):
        total, losses, bn = j_forward(jarch, jtcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return total, (losses, bn)

    (j_total, (j_losses, j_bn)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx, _ = j_build_optimizer(j_get_cfg(), params)

    @jax.jit
    def j_step(p, g, bn):
        updates, _ = tx.update(g, tx.init(p), p)
        return apply_bn_updates(jax.tree_util.tree_map(lambda a, u: a + u, p, updates), bn)

    j_stepped = j_step(params, j_grads, j_bn)

    model.train()
    tb = {k: (v if k == "content_hw" else torch.from_numpy(v)) for k, v in batch.items()}
    total, losses = glass_train_forward(model, TrainConfig(**TCFG_KW), tb, JaxReplay(key, 2))
    total.backward()
    bn_after = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    opt = build_optimizer(get_cfg(), model)
    opt.step(0)
    return dict(
        j_total=float(j_total), j_losses={k: float(v) for k, v in j_losses.items()},
        j_grads=state_dict_from_jax_params(jax.device_get(j_grads)), j_bn=jax.device_get(j_bn),
        j_stepped=state_dict_from_jax_params(jax.device_get(j_stepped)),
        total=float(total.detach()), losses={k: float(v.detach()) for k, v in losses.items()},
        model=model, bn_after=bn_after, sd0=sd0,
    )


def test_losses_and_diagnostics_match(run):
    assert set(run["losses"]) == set(run["j_losses"])
    for k, want in run["j_losses"].items():
        np.testing.assert_allclose(run["losses"][k], want, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(run["total"], run["j_total"], rtol=1e-4)
    # the batch exercises the rescue, both branches and the sampler caps
    assert run["losses"]["rpn/num_pos_anchors"] > 0 and run["losses"]["roi_head/num_fg_samples"] > 0


def _l2_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_every_gradient_matches(run):
    grads = {n: p.grad.numpy() for n, p in run["model"].named_parameters()}
    assert set(grads) == {k for k in run["j_grads"] if "running_" not in k}
    bad = {}
    for name, g in grads.items():
        want = run["j_grads"][name].numpy()
        if np.abs(want).max() < 1e-6:  # rounding noise
            ok = np.abs(g - want).max() <= 1e-6
        else:
            ok = _l2_err(g, want) <= (HEAD_L2_TOL if name.startswith(HEADS) else GRAD_L2_TOL)
        if not ok:
            bad[name] = _l2_err(g, want)
    assert not bad, bad


def test_bn_updates_match(run):
    n = 0
    for path, stats in run["j_bn"].items():
        for stat in ("running_mean", "running_var"):
            got = run["bn_after"][f"{path}.{stat}"].numpy()
            np.testing.assert_allclose(got, np.asarray(stats[stat]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{path}.{stat}")
            n += 1
    assert n == len(run["bn_after"])  # every BN of the model updated


def test_one_optimizer_step_matches(run):
    """SGD (momentum 0.9, weight decay 1e-4, none on norms) at step 0."""
    for name, p in run["model"].named_parameters():
        want = run["j_stepped"][name].numpy()
        step = want - run["sd0"][name].numpy()
        err = np.linalg.norm(p.detach().numpy() - want)
        assert err <= GRAD_L2_TOL * np.linalg.norm(step) + 1e-6, name
