"""Test-time augmentation and the given-boxes pass against glass_tpu.

``GlassRunner.forward_with_given_boxes`` and ``GlassRunnerWithTTA.eval_call``
on the ICDAR15 eval configuration cut to a 128 x 160 bucket (f32, the full
character distributions fetched, mask inference on), with TEST.AUG.MIN_SIZES
96 and 128 and MAX_SIZE 160, so that every view and the given-boxes pass
fit the one bucket; the view geometry on tests/test_tta_geometry.py's
cases; and ``python -m glass_tpu_torch.eval --tta`` against
``tools/eval_glass.py --tta`` on the three images and the ``.pth`` of
tests/test_torch_eval_cli.py, with views of 64 and 72 px in its 96 x 96
bucket.  (Not 80 px: there this random model's finest-level proposal NMS
holds a pair of nearly degenerate boxes at IoU 0.70001, 1.4e-5 from the
threshold, and the two sides' f32 rounding of the RPN deltas, 2.5e-5,
keeps different proposals: a knife edge of the input, not of the port.)

Tolerances, those of tests/test_torch_slice.py: boxes 0.05 px + 1e-4
relative, scores 1e-3, text probabilities 2e-3 and their argmax equal
before a knife-edge step (top-two margin under 1e-4), mask probabilities
2e-3 (fetched in float16); the CLIs' ``results.json`` equal and their det
zips' polygons within the 1 px of integer rounding with equal
transcriptions (as tests/test_torch_eval_cli.py).  The merge keeps a box
by rotated NMS: a pair of candidate boxes whose IoU lies within 1e-4 of
the threshold could be kept on one side only, so such a pair is named and
fails the test instead of passing or failing by chance.
"""

import importlib
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.inference import GlassRunner as JRunner
from glass_tpu.inference.tta import GlassRunnerWithTTA as JRunnerWithTTA
from glass_tpu.postprocess.post_processor import scale_rotated_np as j_scale_rotated_np
from glass_tpu.structures import Instances as JInstances
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict

from glass_tpu_torch import eval as port_eval
from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
from glass_tpu_torch.inference.tta import GlassRunnerWithTTA
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.postprocess.np_geometry import pairwise_iou_rotated_np
from glass_tpu_torch.postprocess.post_processor import scale_rotated_np
from glass_tpu_torch.structures import Instances

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_eval_cli import OPTS as CLI_OPTS  # noqa: E402
from test_torch_eval_cli import make_dataset, read_zip, save_random_model  # noqa: E402
from test_torch_slice import EVAL_OPTS, _steps_before_knife_edge  # noqa: E402
from test_torch_slice import TINY_OPTS as SLICE_TINY_OPTS  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICDAR15 = os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml")
TINY_OPTS = SLICE_TINY_OPTS + ["TPU.TEXT_EMIT", "probs", "TEST.AUG.MIN_SIZES", "[96, 128]",
                               "TEST.AUG.MAX_SIZE", "160"]
NMS_KNIFE_EDGE = 1e-4


def image(seed, hw, n_words=6):
    rng = np.random.RandomState(seed)
    img = (rng.rand(*hw, 3) * 60 + 100).astype(np.uint8)
    for _ in range(n_words):
        y, x = rng.randint(0, hw[0] - 18), rng.randint(0, hw[1] - 40)
        img[y:y + 14, x:x + 36] = rng.randint(0, 256, 3)
    return img


@pytest.fixture(scope="module")
def runners():
    """The port's and glass_tpu's runners on one random model; glass_tpu's
    compiles once for detection and once for the given boxes."""
    cfg = get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS)
    pad = np.zeros((128, 160, 3), np.float32)
    pad[:100, :140] = image(0, (100, 140))
    model = random_init_(GlassRCNN(GlassArch.from_config(cfg)), seed=0).eval()
    calibrate_batch_norm_(model, torch.from_numpy(pad), (100, 140))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in state.items()}))
    port = GlassRunner(cfg=cfg, state_dict=state, device="cpu")
    ref = JRunner(None, cfg=j_get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS),
                  params=jax.tree_util.tree_map(np.asarray, params))
    return port, ref


def _assert_heads_close(got, want):
    gp, wp = np.asarray(got.pred_text_prob), np.asarray(want.pred_text_prob)
    steps = _steps_before_knife_edge(wp)
    np.testing.assert_array_equal(gp.argmax(-1)[steps], wp.argmax(-1)[steps])
    np.testing.assert_allclose(gp, wp, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got.pred_masks, np.float32), np.asarray(want.pred_masks, np.float32),
                               atol=2e-3)


@pytest.mark.parametrize("n_boxes", [0, 5, 11])
def test_forward_with_given_boxes_matches_glass_tpu(runners, n_boxes):
    """A 150 x 200 image (scale 0.8 by the demo rule), boxes in its frame;
    more boxes than DETECTIONS_PER_IMAGE (8) keep the first 8."""
    port, ref = runners
    rng = np.random.RandomState(n_boxes)
    boxes = np.stack([rng.uniform(20, 180, n_boxes), rng.uniform(15, 135, n_boxes),
                      rng.uniform(10, 60, n_boxes), rng.uniform(6, 20, n_boxes),
                      rng.uniform(-60, 60, n_boxes)], -1).astype(np.float32)
    given = dict(pred_boxes=boxes, scores=rng.rand(n_boxes).astype(np.float32),
                 orientations=rng.rand(n_boxes, 2).astype(np.float32))
    img = image(1, (150, 200))
    got = port.forward_with_given_boxes(img, Instances((150, 200), **given))
    want = ref.forward_with_given_boxes(img, JInstances((150, 200), **given))
    assert len(got) == len(want) == min(n_boxes, 8)
    np.testing.assert_array_equal(np.asarray(got.pred_rboxes), boxes[:8])
    np.testing.assert_array_equal(np.asarray(got.pred_boxes), np.asarray(want.pred_boxes))
    if n_boxes:
        _assert_heads_close(got, want)


def _nms_knife_edges(tta, img, thresh):
    """Pairs of candidate boxes (all views, in the image's frame) whose IoU
    lies within NMS_KNIFE_EDGE of the merge threshold."""
    boxes = []
    for view, scale, flipped in tta.views(img):
        preds = tta.runner.run_on_resized(view)
        boxes.append(tta.boxes_to_image(preds.pred_boxes, view.shape[1], scale, flipped))
    boxes = np.concatenate(boxes)
    iou = pairwise_iou_rotated_np(boxes, boxes)
    i, j = np.nonzero(np.triu(np.abs(iou - thresh) < NMS_KNIFE_EDGE, 1))
    return [(int(a), int(b), float(iou[a, b])) for a, b in zip(i, j)], len(boxes)


@pytest.mark.parametrize("seed,hw", [(2, (100, 140)), (3, (90, 130))])
def test_tta_eval_call_matches_glass_tpu(runners, seed, hw):
    """Four views (two scales, each flipped), merged, then the heads at
    the primary scale and the post-processor."""
    port, ref = runners
    img = image(seed, hw)
    tta, jtta = GlassRunnerWithTTA(port), JRunnerWithTTA(ref)
    assert len(list(tta.views(img))) == 4
    edges, n_candidates = _nms_knife_edges(tta, img, tta.nms_thresh)
    assert not edges, f"merge pairs (i, j, IoU) within {NMS_KNIFE_EDGE} of the NMS threshold: {edges}"
    assert n_candidates > 8, "the merge must drop boxes for the case to test it"
    got, want = tta.eval_call(img), jtta.eval_call(img)
    assert len(got) == len(want) > 0 and got.image_size == want.image_size == hw
    assert sorted(got.get_fields()) == sorted(want.get_fields())
    np.testing.assert_allclose(np.asarray(got.pred_boxes), np.asarray(want.pred_boxes), atol=0.05, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.scores), np.asarray(want.scores), atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.pred_polygons), np.asarray(want.pred_polygons),
                               atol=0.05, rtol=1e-4)
    texts, _, _ = port.decode_texts(got)
    want_texts, _, _ = ref.decode_texts(want)
    assert texts == want_texts


@pytest.mark.parametrize("case", ["flip_back", "scale_isotropic", "scale_anisotropic"])
def test_view_geometry(case):
    """tests/test_tta_geometry.py's cases through the port's mapping of a
    view's boxes back to the image (``boxes_to_image``) and its
    ``scale_rotated_np``, against glass_tpu's ``scale_rotated_np``."""
    if case == "flip_back":  # x = 30, angle 20 in a 100-wide view, scale 1
        out = GlassRunnerWithTTA.boxes_to_image(np.array([[30.0, 40.0, 20.0, 10.0, 20.0]]), 100, 1.0, True)
        np.testing.assert_allclose(out[0], [70, 40, 20, 10, -20])
        # a view at scale 2, flipped: unflip in the view, then halve
        out = GlassRunnerWithTTA.boxes_to_image(np.array([[30.0, 40.0, 20.0, 10.0, 20.0]]), 100, 2.0, True)
        np.testing.assert_allclose(out[0], [35, 20, 10, 5, -20], atol=1e-4)
    elif case == "scale_isotropic":
        boxes = np.array([[50.0, 40.0, 20.0, 10.0, 35.0]])
        out = scale_rotated_np(boxes, 2.0, 2.0)
        np.testing.assert_allclose(out[0], [100, 80, 40, 20, 35], atol=1e-4)
        np.testing.assert_allclose(scale_rotated_np(out, 0.5, 0.5), boxes, atol=1e-4)
        np.testing.assert_allclose(GlassRunnerWithTTA.boxes_to_image(out, 200, 2.0, False), boxes, atol=1e-4)
    else:
        boxes = np.array([[50.0, 40.0, 20.0, 10.0, 90.0]])
        out = scale_rotated_np(boxes, 2.0, 1.0)
        np.testing.assert_allclose(out[0, [0, 2, 3]], [100, 20, 20], atol=1e-4)
        np.testing.assert_allclose(abs(out[0, 4]), 90, atol=1e-3)
        np.testing.assert_array_equal(out, j_scale_rotated_np(boxes, 2.0, 1.0))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("eval_tta"))
    ds_yaml, img = make_dataset(tmp)
    pth = os.path.join(tmp, "model.pth")
    save_random_model(pth, img)
    common = ["--config", ICDAR15, "--datasets", ds_yaml, "--model", pth, "--tta"]
    opts = [*CLI_OPTS, "TEST.AUG.MIN_SIZES", "[64, 72]", "TEST.AUG.MAX_SIZE", "96"]
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        eval_glass = importlib.import_module("eval_glass")
    finally:
        sys.path.pop(0)
    argv = sys.argv
    sys.argv = ["eval_glass.py", *common, "--output", os.path.join(tmp, "jax"), *opts]
    try:
        eval_glass.main()
    finally:
        sys.argv = argv
    # --batch-size is ignored under --tta (image by image), as in the reference
    port_eval.main([*common, "--output", os.path.join(tmp, "port"), "--device", "cpu", "--batch-size", "2",
                    *opts])
    return tmp


def test_eval_cli_tta_results_json_equal(cli_runs):
    with open(os.path.join(cli_runs, "port", "results.json")) as f:
        got = json.load(f)
    with open(os.path.join(cli_runs, "jax", "results.json")) as f:
        want = json.load(f)
    assert set(want["toy_test"]) == {"E2E_RESULTS", "DETECTION_ONLY_RESULTS"}
    assert got == want


def test_eval_cli_tta_det_zip_equal(cli_runs):
    got = read_zip(os.path.join(cli_runs, "port", "toy_test_det.zip"))
    want = read_zip(os.path.join(cli_runs, "jax", "toy_test_det.zip"))
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in want.values()) >= 3, "too few words: the comparison tests little"
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for (gc, gt), (wc, wt) in zip(got[name], want[name]):
            assert np.abs(gc - wc).max() <= 1, (name, gc, wc)
            assert gt == wt, (name, gt, wt)
