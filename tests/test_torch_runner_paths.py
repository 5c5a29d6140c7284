"""The serving paths of ``GlassRunner``: its two resize rules and input
formats against glass_tpu's runner, every batched entry point against its
one-image twin, and the one-image fetch against the rows of a batch.

(a) and (b) stop each entry point where the resized image leaves the host
stage (``run_on_resized`` / ``dispatch_batch``) and hold that array
to what glass_tpu's runner hands the same method, bit for bit: no model
runs.  (c) and (e) hold the port to itself bit for bit, (d) to glass_tpu's
runner on the same weights at the slice's tolerances
(tests/test_torch_slice.py).  The ICDAR15 eval configuration cut to a
128 x 160 bucket, as in tests/test_torch_batch_eval.py.
"""

import contextlib

import jax
import numpy as np
import pytest

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.data.mapper import shortest_edge_size as j_shortest_edge_size
from glass_tpu.inference import GlassRunner as JRunner
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict

from glass_tpu_torch.inference.runner import shortest_edge_size
from test_torch_batch_eval import EVAL_OPTS, ICDAR15, TINY_OPTS, _assert_close, _assert_same, _runner, images
from test_torch_batch_eval import model  # noqa: F401  (the fixture)

# MIN/MAX_SIZE_TEST 128/160 and MAX_UPSCALE_RATIO 2
SIZES = {
    "down": (200, 300),
    "up_capped": (30, 50),
    "up": (70, 100),
    "ratio_1": (128, 150),
    "portrait": (300, 180),
    "landscape": (120, 400),
    "odd_h": (131, 150),
    "odd_w": (90, 157),
}
# entry point -> (call, the method the resized image goes to, glass_tpu's rule)
ENTRIES = {
    "call": (lambda r, im: r(im), "run_on_resized", "scale"),
    "batch_call": (lambda r, im: r.batch_call([im]), "dispatch_batch", "scale"),
    "eval_call": (lambda r, im: r.eval_call(im), "run_on_resized", "shortest_edge"),
    "eval_batch_call": (lambda r, im: r.eval_batch_call([im]), "dispatch_batch", "shortest_edge"),
}


class _Stop(Exception):
    pass


@contextlib.contextmanager
def _resized_input(runner, method):
    """``runner.<method>`` replaced by a stop that records the resized
    image it is given (the first of a batch's list)."""
    got = []

    def stop(arg, *rest):
        got.append(arg[0] if isinstance(arg, list) else arg)
        raise _Stop

    setattr(runner, method, stop)
    try:
        yield got
    finally:
        delattr(runner, method)


def _resized(runner, entry, image):
    call, method, _ = ENTRIES[entry]
    with _resized_input(runner, method) as got, pytest.raises(_Stop):
        call(runner, image)
    return got[0]


@pytest.fixture(scope="module")
def runners(model):
    """The port's runner and glass_tpu's without its model: the host stage
    up to the resized image is all that (a) and (b) run of it."""
    jrunner = JRunner.__new__(JRunner)
    cfg = j_get_cfg(ICDAR15, EVAL_OPTS + TINY_OPTS)
    jrunner.cfg = cfg
    jrunner.min_target_size, jrunner.max_target_size = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
    jrunner.max_upscale_ratio, jrunner.input_format = cfg.INPUT.MAX_UPSCALE_RATIO, cfg.INPUT.FORMAT
    jrunner.pad_multiple = cfg.TPU.PAD_IMAGE_TO_MULTIPLE
    jrunner.buckets = [tuple(b) for b in cfg.TPU.IMAGE_BUCKETS]
    return _runner(model), jrunner


def _same_array(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_resize_rule_matches_glass_tpu(runners, entry, size):
    """Each entry point's resize rule: the arithmetic, then the resized
    array (float32; uint8 on ``eval_batch_call``'s TPU.EVAL_UINT8_TRANSFER
    path) bit for bit."""
    runner, jrunner = runners
    h, w = SIZES[size]
    image = images(11, 1, (h, w))[0]
    if ENTRIES[entry][2] == "scale":
        ratio = runner.get_inference_scale_ratio(image.shape)
        assert ratio == JRunner.get_inference_scale_ratio(jrunner, image.shape)
        want_hw = (h, w) if ratio == 1 else (int(np.round(ratio * h)), int(np.round(ratio * w)))
    else:
        want_hw = shortest_edge_size(h, w, 128, 160)
        assert want_hw == j_shortest_edge_size(h, w, 128, 160)
    got = _resized(runner, entry, image)
    want = _resized(jrunner, entry, image)
    _same_array(got, want)
    assert got.shape[:2] == want_hw
    assert got.dtype == (np.uint8 if entry == "eval_batch_call" else np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("fmt", ["RGB", "BGR", "GREY"])
def test_input_format_matches_glass_tpu(runners, fmt, dtype):
    """INPUT.FORMAT: the BGR image each resize rule is given, seen through
    the resized arrays of ``__call__`` and ``eval_batch_call`` (which keeps
    a uint8 image uint8), against glass_tpu's."""
    runner, jrunner = runners
    image = images(12, 1, (200, 300))[0].astype(dtype)
    if dtype == "float32":
        image += np.linspace(0.0, 0.75, image.size, dtype=np.float32).reshape(image.shape)
    saved = runner.input_format, jrunner.input_format
    runner.input_format = jrunner.input_format = fmt
    try:
        for entry in ("call", "eval_batch_call"):
            got = _resized(runner, entry, image)
            _same_array(got, _resized(jrunner, entry, image))
            if fmt == "GREY":
                assert np.array_equal(got[..., 0], got[..., 2])
            elif entry == "eval_batch_call" and dtype == "uint8":
                assert not np.array_equal(got[..., 0], got[..., 2])
    finally:
        runner.input_format, jrunner.input_format = saved


# images of each regime of both rules: two sizes a regime, one bucket
REGIMES = {
    "down": [(200, 300), (180, 280)],
    "up": [(60, 80), (70, 90)],
    "ratio_1": [(128, 150), (128, 160)],
}


@pytest.mark.parametrize("post_process", [True, False], ids=["post", "raw"])
@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("rule", ["scale", "shortest_edge"])
def test_batch_entry_equals_single_entry(model, rule, regime, post_process):
    """``batch_call`` against ``__call__`` and ``eval_batch_call`` against
    ``eval_call``, image by image, bit for bit.  Two batches of one image:
    ``eval_batch_call`` pipelines them (TPU.ASYNC_FETCH), ``batch_call``
    runs them in turn.  ``eval_call`` resizes in float32, so
    ``eval_batch_call`` does too here (TPU.EVAL_UINT8_TRANSFER off)."""
    imgs = [images(20 + i, 1, hw)[0] for i, hw in enumerate(REGIMES[regime])]
    runner = _runner(model, "TPU.EVAL_UINT8_TRANSFER", "False", post_process=post_process)
    if rule == "scale":
        got, want = runner.batch_call(imgs, batch_size=1), [runner(im) for im in imgs]
    else:
        got, want = runner.eval_batch_call(imgs, batch_size=1), [runner.eval_call(im) for im in imgs]
    assert sum(len(p) for p in want) > 0, "no word survived: the case tests nothing"
    _assert_same(got, want)
    assert [p.image_size for p in got] == [im.shape[:2] for im in imgs]
    assert all(p.has("pred_polygons") == post_process for p in got)


@pytest.fixture(scope="module")
def jrunner_probs(model):
    """glass_tpu's runner on the same weights, with the full character
    distributions fetched (TPU.TEXT_EMIT probs) to find knife-edge steps."""
    opts = EVAL_OPTS + TINY_OPTS + ["TPU.TEXT_EMIT", "probs"]
    params = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in model.items()}))
    return JRunner(None, cfg=j_get_cfg(ICDAR15, opts), params=jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("entry", ["eval_call", "batch_call"])
def test_entry_matches_glass_tpu(model, jrunner_probs, entry):
    """``eval_call`` against glass_tpu's ``eval_call``; ``batch_call``
    against glass_tpu's ``__call__`` image by image (the same program as
    its ``batch_call``'s rows under "map"), a downscaled and an upscaled
    image."""
    imgs = [images(30, 1, (180, 260))[0], images(31, 1, (70, 100))[0]]
    runner = _runner(model, "TPU.TEXT_EMIT", "probs")
    if entry == "eval_call":
        got, want = [runner.eval_call(im) for im in imgs], [jrunner_probs.eval_call(im) for im in imgs]
    else:
        got, want = runner.batch_call(imgs, batch_size=2), [jrunner_probs(im) for im in imgs]
    assert sum(len(p) for p in want) > 0
    _assert_close(got, want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.pred_polygons), np.asarray(w.pred_polygons), atol=0.05, rtol=1e-4)


FETCHES = {
    "f16_topk": ["TPU.MASK_FETCH_DTYPE", "float16", "TPU.TEXT_EMIT", "topk"],
    "f16_probs": ["TPU.MASK_FETCH_DTYPE", "float16", "TPU.TEXT_EMIT", "probs"],
    "u8_topk": ["TPU.MASK_FETCH_DTYPE", "uint8", "TPU.TEXT_EMIT", "topk"],
    "u8_probs": ["TPU.MASK_FETCH_DTYPE", "uint8", "TPU.TEXT_EMIT", "probs"],
    "f16_no_masks": ["TPU.MASK_FETCH_DTYPE", "float16", "MODEL.ROI_MASK_HEAD.MASK_INFERENCE", "False"],
    "u8_no_masks": ["TPU.MASK_FETCH_DTYPE", "uint8", "MODEL.ROI_MASK_HEAD.MASK_INFERENCE", "False"],
}


@pytest.mark.parametrize("fetch", list(FETCHES))
def test_one_image_fetch_equals_batch_rows(model, fetch):
    """``run_on_resized`` (``run_model``, then the unpack) against the rows
    of ``run_batch_on_resized`` (the packed fetch, then the same unpack),
    every field bit for bit, per fetched mask dtype and text form."""
    runner = _runner(model, *FETCHES[fetch], post_process=False)
    imgs = [im.astype(np.float32) for im in images(40, 2, (114, 160))]
    single = [runner.run_on_resized(im) for im in imgs]
    assert sum(len(p) for p in single) > 0
    _assert_same(runner.run_batch_on_resized(imgs), single)
    fields = set(single[0].get_fields())
    masks = "MASK_INFERENCE" not in " ".join(FETCHES[fetch])
    assert (fields & {"pred_masks", "pred_rboxes"}) == ({"pred_masks", "pred_rboxes"} if masks else set())
    assert ("pred_text_prob" in fields) == fetch.endswith("probs")
    assert ("pred_text_ids" in fields) == (not fetch.endswith("probs"))
    if masks:
        assert single[0].pred_masks.dtype == (np.float32 if fetch.startswith("u8") else np.float16)
