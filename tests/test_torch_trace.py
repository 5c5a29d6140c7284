"""The port's spans and counters (``glass_tpu_torch.utils.trace``) and the
benchmark's readers of them.

With no profiler running, ``span`` is one shared no-op and nothing is
recorded.  Under ``torch.profiler``, ``GlassRunner.__call__`` and
``eval_batch_call`` (batch 2, TPU.ASYNC_FETCH, two chunks) record every
span of the runner and the host stage with the expected calls, those of
the profiled thread also on the profiler's timeline; the merge and
polygon spans lie inside their image's ``glass.post`` and share its
request id; ``glass.post.words`` counts the instances entering the host
stage; and the outputs are those of an unprofiled run.  The ICDAR15 eval
configuration at a 128 x 160 bucket, as ``tests/test_torch_batch_eval.py``.
"""

import collections
import importlib.util
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.utils import trace

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICDAR15 = os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml")
OPTS = [
    "MODEL.ROI_HEADS.NMS_THRESH_TEST", "0.35", "INFERENCE_TH_TEST", "0.3",
    "MODEL.ROI_MASK_HEAD.MASK_INFERENCE", "True", "MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES", "False",
    "INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "160", "TPU.IMAGE_BUCKETS", "[[128, 160]]",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "TEST.DETECTIONS_PER_IMAGE", "8", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "5",
    "TPU.COMPUTE_DTYPE", "float32", "POST_PROCESSING.VALID_CONFIDENCE", "0.0",
    "POST_PROCESSING.DETECT_THRESHOLD", "0.0", "POST_PROCESSING.TEXT_THRESHOLD", "0.0",
    "TPU.ASYNC_FETCH", "True",
]
RUNNER_SPANS = ("glass.resize", "glass.upload", "glass.dispatch", "glass.fetch", "glass.post",
                "glass.post.merge", "glass.post.polygons")


def images(seed, n, hw=(100, 140)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = (rng.rand(*hw, 3) * 60 + 100).astype(np.uint8)
        for _ in range(6):
            y, x = rng.randint(0, hw[0] - 16), rng.randint(0, hw[1] - 40)
            img[y:y + 12, x:x + 34] = rng.randint(0, 256, 3)
        out.append(img)
    return out


@pytest.fixture(scope="module")
def runner():
    cfg = get_cfg(ICDAR15, OPTS)
    pad = np.zeros((128, 160, 3), np.float32)
    pad[:114, :160] = images(0, 1, (114, 160))[0]
    m = random_init_(GlassRCNN(GlassArch.from_config(cfg)), seed=0).eval()
    calibrate_batch_norm_(m, torch.from_numpy(pad), (114, 160))
    return GlassRunner(cfg=cfg, state_dict=m.state_dict(), device="cpu")


def _words_in(runner):
    """Wrap the runner's host stage entry to count the instances entering
    it; returns the list of counts."""
    seen = []
    inner = runner._model_postprocess

    def counted(preds, h, w):
        seen.append(len(preds))
        return inner(preds, h, w)

    runner._model_postprocess = counted
    return seen, lambda: setattr(runner, "_model_postprocess", inner)


def _profiled(runner, fn):
    trace.reset()
    seen, restore = _words_in(runner)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        restore()
    return out, prof, seen


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.image_size == y.image_size and sorted(x.get_fields()) == sorted(y.get_fields())
        for k in x.get_fields():
            u, v = x.get(k), y.get(k)
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v)
            else:
                assert repr(u) == repr(v), k


def test_span_off_is_one_shared_noop_and_records_nothing():
    trace.reset()
    assert trace.span("glass.a") is trace.span("glass.b", rid=3)
    with trace.span("glass.a", rid=1):
        trace.count("glass.c", 5)
    assert trace.totals() == {} and trace.records() == []


def test_the_profiler_switches_recording_on_every_thread():
    import threading

    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("glass.main", rid=7):
            t = threading.Thread(target=_one_span, args=("glass.worker",))
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    recs = trace.records()
    assert sorted(r[0] for r in recs) == ["glass.main", "glass.worker"]
    main, worker = sorted(recs)
    assert worker[1] is None and main[1] == 7 and worker[2] != main[2]  # a rid is per thread
    assert [e.name for e in prof.events()].count("glass.main") == 1
    with trace.span("glass.after"):
        pass
    assert len(trace.records()) == 2
    trace.reset()


def _one_span(name):
    with trace.span(name):
        pass


@pytest.mark.parametrize("path", ["call", "eval_batch"])
def test_spans_cover_the_runner_and_the_host_stage(runner, path):
    imgs = images(1, 4)
    if path == "call":
        imgs = imgs[:2]
        fn = lambda: [runner(im) for im in imgs]  # noqa: E731
        want = {"glass.resize": 2, "glass.upload": 2, "glass.dispatch": 2, "glass.fetch": 2,
                "glass.post": 2}
    else:
        fn = lambda: runner.eval_batch_call(imgs, batch_size=2)  # noqa: E731
        want = {"glass.resize": 4, "glass.upload": 2, "glass.dispatch": 2, "glass.fetch": 2,
                "glass.pipeline_wait": 2, "glass.post": 4}
    plain = fn()
    base = runner.calls if path == "call" else 0  # serving's request ids count the runner's calls
    got, prof, seen = _profiled(runner, fn)
    _same(got, plain)

    tot, recs = trace.totals(), trace.records()
    for name, calls in want.items():
        assert tot[name][1] == calls, name
        assert tot[name][0] > 0, name
    assert all(s > 0 for s in seen), "every image reaches the merge and the polygons"
    assert tot["glass.post.merge"][1] == tot["glass.post.polygons"][1] == len(imgs)
    assert tot["glass.post.words"] == sum(seen)
    assert "glass.pipeline_wait" not in tot if path == "call" else True

    # the profiled thread's spans are on the profiler's timeline too
    main = collections.Counter(r[2] for r in recs if r[0] == "glass.post").most_common(1)[0][0]
    events = collections.Counter(e.name for e in prof.events())
    for name in {r[0] for r in recs if r[2] == main}:
        assert events[name] == sum(1 for r in recs if r[0] == name and r[2] == main), name

    # the stage's parts lie inside their image's glass.post and share its rid
    posts = [r for r in recs if r[0] == "glass.post"]
    rids = list(range(base, base + len(imgs)))
    assert sorted(r[1] for r in posts) == rids
    for r in recs:
        if r[0] in ("glass.post.merge", "glass.post.polygons"):
            assert any(p[2] == r[2] and p[3] <= r[3] and r[4] <= p[4] and p[1] == r[1] for p in posts), r
    if path == "call":
        by_rid = collections.defaultdict(set)
        for r in recs:
            by_rid[r[1]].add(r[0])
        assert all(set(RUNNER_SPANS) <= by_rid[k] for k in rids)  # with the model's stage spans
    else:
        first = sorted({r[1] for r in recs if r[0] in ("glass.upload", "glass.pipeline_wait")})
        assert len(first) == 2 and set(first) <= set(rids)
    trace.reset()


# -- the benchmark's readers of the spans --------------------------------

READERS = [
    ("resize_ms.eval", "glass.resize"), ("resize_ms.serve", "glass.resize"),
    ("upload_ms.eval", "glass.upload"), ("upload_ms.serve", "glass.upload"),
    ("dispatch_ms.eval", "glass.dispatch"), ("dispatch_ms.serve", "glass.dispatch"),
    ("fetch_ms.eval", "glass.fetch"), ("fetch_ms.serve", "glass.fetch"),
    ("pipeline_wait_ms.eval", "glass.pipeline_wait"),
    ("post_ms.eval", "glass.post"), ("post_ms.serve", "glass.post"),
    ("post_merge_ms.eval", "glass.post.merge"), ("post_merge_ms.serve", "glass.post.merge"),
    ("post_polygons_ms.eval", "glass.post.polygons"), ("post_polygons_ms.serve", "glass.post.polygons"),
    ("post_words_per_img.eval", "glass.post.words"), ("post_words_per_img.serve", "glass.post.words"),
]


def _reader(metric):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("metric,name", READERS, ids=[m for m, _ in READERS])
def test_reader_arithmetic_and_none(monkeypatch, metric, name):
    read = _reader(metric)
    words = name == "glass.post.words"
    totals = {name: 30 if words else [0.6, 12]}
    monkeypatch.setattr(trace, "totals", lambda: dict(totals))
    r = types.SimpleNamespace(trace=object(), traced_units=8)
    assert read(r) == pytest.approx(30 / 8 if words else 0.6 / 8 * 1e3)
    assert read(types.SimpleNamespace(trace=None, traced_units=8)) is None
    assert read(types.SimpleNamespace(trace=object(), traced_units=0)) is None
    totals.clear()
    assert read(r) is None
