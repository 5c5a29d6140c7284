"""configs/glass_finetune_totaltext.yaml: the port against glass_tpu.

Both packages build the model from the config (with the eval protocol
overrides of tools/eval_glass.py for inference), cut to the tiny sizes of
tests/test_torch_slice.py (a 128 x 160 bucket, 8 detections, words of up
to 5 characters, f32).  Three comparisons on one seeded random model:
``glass_inference_single`` on a float and a uint8 image, every output
field; ``GlassRunner.__call__`` with post-processing and text decoding; one
training step (the config's own ``TrainConfig`` at small RPN, ROI and
word counts, glass_tpu's random draws replayed) against ``glass_train_forward``:
losses, every gradient, the BN updates.

The other shipped configs reuse these checks
(tests/test_torch_configs_{textocr,pretrain}.py).

Tolerances, those of tests/test_torch_slice.py and
tests/test_torch_train_step.py: valid equal, boxes 0.05 px + 1e-4
relative, scores and orientations 1e-3, text step scores and masks 2e-3,
text ids equal before a knife-edge step (top-two margin under 1e-4);
losses 1e-4 relative, gradients 1e-3 relative L2 for the heads next to
the losses and 5e-2 for every tensor (the conditioning floor of a random
deep network), BN updates 1e-4 relative.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.inference import GlassRunner as JRunner
from glass_tpu.models import GlassArch as JArch
from glass_tpu.models import glass_inference_single as j_infer
from glass_tpu.text import TextCodec as JTextCodec
from glass_tpu.text import decode_instance_texts as j_decode_texts
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict
from glass_tpu.train.train_step import TrainConfig as JTrainConfig
from glass_tpu.train.train_step import glass_train_forward as j_forward

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN, glass_inference_single
from glass_tpu_torch.train.train_step import TrainConfig, glass_train_forward
from glass_tpu_torch.train.trainer import init_weights_
from glass_tpu_torch.weights import state_dict_from_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_slice import EVAL_OPTS, TINY_OPTS, _assert_outputs_match, synthetic_image  # noqa: E402
from test_torch_train_step import GRAD_L2_TOL, HEAD_L2_TOL, HEADS, JaxReplay, _l2_err, make_batch  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "glass_finetune_totaltext.yaml")
# Training at small sizes: the config's TrainConfig with these opts.  Both
# sides run the scan matcher and the axis sampler: the port has one exact
# matcher and one sampler, and glass_tpu's "pool" sampler (its default)
# takes its random positives from another stream, which replayed draws
# cannot follow.  Finetuning takes 4 words an image (as
# tests/test_torch_train_step.py), not the configs' 8: at 8 (16 recognizer
# rows) glass_tpu's f32 local CNN on the CPU lies 5.3e-4 from an f64
# evaluation of the same network and the port's 2.6e-5, and loss_decoder
# moves by 1.3e-4 relative, the ICDAR15 config's included.
TRAIN_OPTS = [
    "TPU.COMPUTE_DTYPE", "float32", "TEST.DETECTIONS_PER_IMAGE", "8",
    "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "5", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "16", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
    "TPU.MATCH_BACKEND", "scan", "TPU.RPN_SAMPLER", "axis",
]
FINETUNE_WORDS = ["MODEL.ROI_RECOGNIZER_HEAD.MAX_BATCH_SIZE", "4"]
def to_params(state):
    """A port state dict -> glass_tpu's parameter tree (numpy leaves).
    glass_tpu looks up a subtree for every recognizer module, also for one
    without parameters (LocalOnly's ``fusion_net``, the Identity
    ``backbone``), which the converter, seeing no tensor of it, does not
    make: an empty one is added here.  The leaves are copies: on the CPU
    JAX may alias a numpy array's memory, and the port's training forward
    updates its BN statistics in place while glass_tpu's asynchronously
    dispatched step may still read them."""
    params = _walk_rename(convert_torch_state_dict({k: v.detach().numpy().copy() for k, v in state.items()}))
    rh = params.get("roi_heads", {})
    if "recognizer_head" in rh:
        rh.setdefault("fusion_net", {})
        rh["recognizer_head"].setdefault("backbone", {})
    return jax.tree_util.tree_map(np.asarray, params)


def inference_model(config, image, hw, load=None, opts=()):
    """Seeded random weights, ``load(model)`` overlaying some of them, BN
    statistics calibrated on ``image`` (the padded bucket, content ``hw``),
    as tests/test_torch_slice.py calibrates each model on the image it
    runs; the port's model takes its weights back from glass_tpu's tree
    (the weight carry-over).  ``opts`` follow the eval and tiny opts.
    -> (port model, glass_tpu params)."""
    arch = GlassArch.from_config(get_cfg(config, EVAL_OPTS + TINY_OPTS + list(opts)))
    model = random_init_(GlassRCNN(arch), seed=0).eval()
    if load is not None:
        load(model)
    calibrate_batch_norm_(model, torch.from_numpy(image), hw)
    params = to_params(model.state_dict())
    port = GlassRCNN(arch).eval()
    port.load_state_dict(state_dict_from_jax_params(params))
    return port, params


def check_inference_single(config, dtype, load=None, opts=(), compare=_assert_outputs_match):
    """``glass_inference_single`` at the config's architecture (plus
    ``opts``) on a 128 x 160 image with content 120 x 150, every output
    field, held to glass_tpu's by ``compare(got, want)``."""
    opts = EVAL_OPTS + TINY_OPTS + list(opts)
    img = synthetic_image(0, 128, 160)
    port, params = inference_model(config, img, (120, 150), load, opts[len(EVAL_OPTS + TINY_OPTS):])
    img = img.astype(dtype)
    jarch = dataclasses.replace(JArch.from_config(j_get_cfg(config, opts)), text_emit="probs")
    want = jax.device_get(jax.jit(lambda p, i, hw: j_infer(jarch, p, i, hw))(
        params, jnp.asarray(img), jnp.asarray((120, 150), jnp.int32)))
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in glass_inference_single(port, torch.from_numpy(img), (120, 150)).items()}
    assert got["valid"].any()
    assert set(got) - {"text_ids", "text_step_scores"} == set(want) - {"text_probs"}
    compare(got, {k: np.asarray(v) for k, v in want.items()})
    return port, got


def check_runner_call(config, load=None, opts=()):
    """``__call__`` on a 100 x 140 image: scale rule, bucket, model,
    detector_postprocess, the merge post-processor, text decoding."""
    extra = list(opts)
    opts = EVAL_OPTS + TINY_OPTS + extra
    cfg, jcfg = get_cfg(config, opts), j_get_cfg(config, opts)
    image = synthetic_image(1, 100, 140)
    pad = np.zeros((128, 160, 3), np.float32)
    pad[:100, :140] = image
    port, params = inference_model(config, pad, (100, 140), load, extra)
    want = JRunner(None, cfg=jcfg, params=params)(image)
    runner = GlassRunner(cfg=cfg, state_dict=port.state_dict(), device="cpu")
    got = runner(image)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(np.asarray(got.pred_boxes), np.asarray(want.pred_boxes), atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores), atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.pred_polygons), np.asarray(want.pred_polygons),
                               atol=0.05, rtol=1e-4)
    texts, _, _ = runner.decode_texts(got)
    want_texts, _, _ = j_decode_texts(want, JTextCodec.from_config(jcfg))
    assert texts == want_texts
    return got, texts


def train_step(config, batch, opts=(), model=None, params=None, seed=5):
    """One training forward and backward on both sides from the same
    weights (the port's training init unless given) and the same draws."""
    opts = TRAIN_OPTS + list(opts)
    cfg, jcfg = get_cfg(config, opts), j_get_cfg(config, opts)
    if model is None:
        model = init_weights_(GlassRCNN(GlassArch.from_config(cfg)), 0)
    if params is None:
        params = to_params(model.state_dict())
    jarch = JArch.from_config(jcfg)
    jtcfg = dataclasses.replace(JTrainConfig.from_config(jcfg), match_topk=16384)  # the exact matcher
    key = jax.random.PRNGKey(seed)

    def loss_fn(p):
        total, losses, bn = j_forward(jarch, jtcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return total, (losses, bn)

    (j_total, (j_losses, j_bn)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model.train()
    b = batch["images"].shape[0]
    tb = {k: (v if k == "content_hw" else torch.from_numpy(v)) for k, v in batch.items()}
    tcfg = TrainConfig.from_config(cfg)
    total, losses = glass_train_forward(model, tcfg, tb, JaxReplay(key, b))
    total.backward()
    return dict(
        tcfg=tcfg, j_total=float(j_total), j_losses={k: float(v) for k, v in j_losses.items()},
        j_grads=state_dict_from_jax_params(jax.device_get(j_grads)), j_bn=jax.device_get(j_bn),
        total=float(total.detach()), losses={k: float(v.detach()) for k, v in losses.items()},
        model=model, bn_after={k: v.clone() for k, v in model.state_dict().items() if "running_" in k},
    )


def check_train_step(run):
    """Losses, every gradient and every BN update against glass_tpu."""
    assert set(run["losses"]) == set(run["j_losses"])
    for k, want in run["j_losses"].items():
        np.testing.assert_allclose(run["losses"][k], want, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(run["total"], run["j_total"], rtol=1e-4)
    assert run["losses"]["rpn/num_pos_anchors"] > 0 and run["losses"]["roi_head/num_fg_samples"] > 0
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
    n = 0
    for path, stats in run["j_bn"].items():
        for stat in ("running_mean", "running_var"):
            np.testing.assert_allclose(run["bn_after"][f"{path}.{stat}"].numpy(), np.asarray(stats[stat]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{path}.{stat}")
            n += 1
    assert n == len(run["bn_after"])


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_inference_single_matches_glass_tpu(dtype):
    port, out = check_inference_single(CONFIG, dtype)
    assert port.arch.orientation_on and np.abs(out["orientations"]).sum() > 0


def test_runner_call_matches_glass_tpu():
    check_runner_call(CONFIG)


def test_train_step_matches_glass_tpu():
    run = train_step(CONFIG, make_batch(), FINETUNE_WORDS)
    assert run["tcfg"].words_per_image == 4 and run["model"].arch.orientation_on
    check_train_step(run)
