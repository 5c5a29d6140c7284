"""Training with CTC and with FeatPadV2: the port against glass_tpu.

One training step on the ICDAR15 finetune config with each option
(tests/test_torch_configs_totaltext.py's ``train_step``: the port's seeded
training init carried to glass_tpu's tree, two 64 x 64 images, glass_tpu's
random draws replayed, the scan matcher and axis sampler on both sides, 4
words an image of up to 5 characters), then the SGD step from the same
gradients: losses, every gradient, every BN update and the stepped weights.
CTC's batch encodes its words as the ctc codec does (no GO or stop slot,
0-padded, an empty word all zeros, which the ``empty_sum`` rule leaves out);
FeatPadV2 trains on tests/test_torch_train_step.py's batch, and K1b's plain
version backpropagates through the widened pool boxes.

``ctc_loss_masked`` on its own against glass_tpu's (``optax.ctc_loss``):
feasible words, a word its steps cannot hold (finite, as optax's), and the
word mask; ``torch.nn.functional.ctc_loss`` is a yardstick on feasible
words only (it gives inf where optax gives its ``LOG_EPSILON`` value).

Tolerances, those of tests/test_torch_train_step.py: losses 1e-4 relative,
the heads' gradients 1e-3 relative L2 and every gradient 5e-2, BN 1e-4,
the stepped weights within the gradients' bound; the CTC loss 1e-4
relative in value and 1e-3 relative L2 in gradient.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.train import losses as JLS
from glass_tpu.train.optimizer import apply_bn_updates, build_optimizer as j_build_optimizer

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.models.glass_rcnn import _check_ported
from glass_tpu_torch.train import losses as LS
from glass_tpu_torch.train.optimizer import build_optimizer
from glass_tpu_torch.train.train_step import check_trainable
from glass_tpu_torch.train.trainer import init_weights_
from glass_tpu_torch.weights import state_dict_from_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_configs_totaltext import (  # noqa: E402
    FINETUNE_WORDS, ROOT, TRAIN_OPTS, check_train_step, to_params, train_step,
)
from test_torch_train_step import GRAD_L2_TOL, _l2_err, make_batch  # noqa: E402

torch.set_num_threads(2)
ICDAR15 = os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml")
CTC = ["MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.DECODER.NAME", "CTC",
       "MODEL.ROI_RECOGNIZER_HEAD.LABELS_TYPE", "ctc"]
FEATPAD = ["MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.POOLER_PAD.NAME", "FeatPadV2"]


def ctc_batch(seed=0, t=5):
    """tests/test_torch_train_step.py's batch with its words encoded as the
    ctc codec does (1-4 characters of 1..95, 0-padded to ``t``), one word
    with a repeated letter and one empty word."""
    batch = make_batch(seed=seed)
    rng = np.random.RandomState(seed + 1)
    b, g = batch["gt_boxes"].shape[:2]
    text = np.zeros((b, g, t), np.int32)
    for bi in range(b):
        for gi in range(g):
            n = rng.randint(1, t)
            text[bi, gi, :n] = rng.randint(1, 96, n)
    text[0, 1, :3] = (7, 7, 9)
    text[1, 2] = 0
    batch["gt_text"] = text
    return batch


def sgd_step_matches(run, params):
    """The port's SGD step (momentum 0.9, weight decay 1e-4, none on
    norms) at step 0 against glass_tpu's optimizer on glass_tpu's
    gradients, within the gradients' bound."""
    sd0 = {k: torch.from_numpy(np.asarray(v)) for k, v in state_dict_from_jax_params(params).items()}
    j_grads = to_params(run["j_grads"])
    tx, _ = j_build_optimizer(j_get_cfg(), params)

    @jax.jit
    def j_step(p, g, bn):
        updates, _ = tx.update(g, tx.init(p), p)
        return apply_bn_updates(jax.tree_util.tree_map(lambda a, u: a + u, p, updates), bn)

    stepped = state_dict_from_jax_params(jax.device_get(j_step(params, j_grads, run["j_bn"])))
    model = run["model"]
    build_optimizer(get_cfg(), model).step(0)
    for name, p in model.named_parameters():
        want = stepped[name].numpy()
        err = np.linalg.norm(p.detach().numpy() - want)
        assert err <= GRAD_L2_TOL * np.linalg.norm(want - sd0[name].numpy()) + 1e-6, name


@pytest.mark.parametrize("option", ["CTC", "FeatPadV2"])
def test_train_step_matches_glass_tpu(option):
    opts = (CTC if option == "CTC" else FEATPAD) + FINETUNE_WORDS
    cfg = get_cfg(ICDAR15, TRAIN_OPTS + opts)
    model = init_weights_(GlassRCNN(GlassArch.from_config(cfg)), 0)
    params = to_params(model.state_dict())
    batch = ctc_batch() if option == "CTC" else make_batch()
    run = train_step(ICDAR15, batch, opts, model=model, params=params)
    assert run["tcfg"].words_per_image == 4
    assert run["model"].roi_heads.recognizer_head.ctc == (option == "CTC")
    assert run["losses"]["loss_decoder"] > 0
    check_train_step(run)
    sgd_step_matches(run, params)


def _ctc_case(case):
    """(logits (N, 32, V), targets (N, 5), word mask (N,)) of one case."""
    rng = np.random.RandomState({"feasible": 0, "infeasible": 1, "masked": 2}[case])
    n, t, v = 6, 32, 12
    logits = rng.randn(n, t, v).astype(np.float32) * 2
    targets = np.zeros((n, 5), np.int32)
    for i in range(n):
        k = rng.randint(1, 6)
        targets[i, :k] = rng.randint(1, v, k)
    targets[1, :4] = (3, 3, 5, 5)  # repeats need a blank between them
    mask = np.ones(n, bool)
    if case == "infeasible":
        # 4 steps cannot hold [1, 1, 1] (it needs 5: 1 _ 1 _ 1)
        logits, targets = logits[:, :4], np.array([[1, 1, 1, 0, 0]] * n, np.int32)
        targets[1:, 1:] = 0
    if case == "masked":
        mask[[0, 3]] = False
    return logits, targets, mask


@pytest.mark.parametrize("case", ["feasible", "infeasible", "masked"])
def test_ctc_loss_matches_glass_tpu(case):
    logits, targets, mask = _ctc_case(case)
    want, want_g = jax.value_and_grad(lambda x: JLS.ctc_loss_masked(x, jnp.asarray(targets), jnp.asarray(mask)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = LS.ctc_loss_masked(x, torch.from_numpy(targets), torch.from_numpy(mask))
    got.backward()
    got = float(got.detach())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(want), rtol=1e-4)
    assert _l2_err(x.grad.numpy(), np.asarray(want_g)) <= 1e-3
    if case == "infeasible":
        per_word = LS.ctc_loss(x.detach()[:1], torch.from_numpy(targets[:1]),
                               torch.from_numpy((targets[:1] == 0).astype(np.float32)))
        assert 1e4 < float(per_word[0]) < 1e6  # LOG_EPSILON's value, not inf


def test_ctc_loss_feasible_words_match_torch_ctc_loss():
    """The yardstick, on feasible words: F.ctc_loss's per-word NLL (no
    reduction) averaged over the valid words."""
    logits, targets, mask = _ctc_case("masked")
    lens = (targets > 0).sum(1)
    ref = F.ctc_loss(torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
                     torch.from_numpy(targets).long(), torch.full((len(targets),), logits.shape[1]),
                     torch.from_numpy(lens), blank=0, reduction="none")
    want = float((ref * torch.from_numpy(mask)).sum() / mask.sum())
    got = float(LS.ctc_loss_masked(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_float16_still_raises_and_names_its_slice():
    """float16 is ported (it raised, naming its slice, until then): the
    model's check, the trainer's check and ``GlassRunner`` accept it, and
    the runner serves a finite image in fp16; a compute dtype glass_tpu
    does not take still fails.  tests/test_torch_float16.py holds fp16 to
    glass_tpu."""
    _check_ported(dataclasses.replace(GlassArch(), compute_dtype="float16"))
    with pytest.raises(ValueError, match="COMPUTE_DTYPE"):
        _check_ported(dataclasses.replace(GlassArch(), compute_dtype="float64"))
    cfg = get_cfg(ICDAR15, ["TPU.COMPUTE_DTYPE", "float16", "INPUT.MIN_SIZE_TEST", "64",
                            "INPUT.MAX_SIZE_TEST", "96", "TPU.IMAGE_BUCKETS", "[[96, 128]]",
                            "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
                            "TEST.DETECTIONS_PER_IMAGE", "8", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "4"])
    check_trainable(cfg)
    runner = GlassRunner(cfg=cfg, device="cpu")
    assert runner.model.arch.torch_dtype == torch.float16
    out = runner.run_model((np.random.RandomState(0).rand(90, 110, 3) * 255).astype(np.float32))
    assert out["valid"].shape == (8,)
    for k, v in out.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            assert np.isfinite(v.astype(np.float32)).all(), k
