"""The three loops a traffic file can name (its ``loop``), each a closed
loop on one card: set-up (weights, inputs, the program, a warm-up of the
cell's own shapes), the measured window, the traced part of a
``--trace 1`` window, and the comparison with the reference once the
window has closed and the program is freed.

* ``eval_batch``: ``GlassRunner.eval_batch_call`` over the mix's pool of
  scenes at its batch size, call after call (host numpy in, post-processed
  instances out: resize, upload, model, fetch and host stage inside);
* ``serve_call``: one client calling ``GlassRunner.__call__`` on the pool's
  scenes in turn, each request sent when the last returned;
* ``train_steps``: ``make_parallel_train_loop`` one step a batch over the
  pool's training batches, after the checked first steps of set-up.

Each returns a ``Result``: the end-to-end readings, the ``Reading`` the
per-layer readers take, and the numbers the comparison produced.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..reference import config as ref_config
from ..reference import train as ref_train
from ..reference.glass.models import rpn as ref_rpn
from ..reference.runner import RefRunner, build_model
from . import judge, roofline, traffic, weights
from .capture import Capture, StepRecorder
from .trace import Traced


@dataclass
class Reading:
    """What a per-layer reader takes (``benchmark/metrics/<name>.py``)."""

    kind: str                      # "eval", "serve" or "train"
    window_s: float                # the whole window, host clock
    window_units: int              # images (eval, serve) or steps (train) completed in it
    traced_units: int = 0          # of them, in the traced part
    traced_wall_s: float = 0.0     # the traced part's length, host clock
    trace: object = None           # TraceSummary of the traced part
    host_spans: dict = field(default_factory=dict)   # name -> [seconds, calls], untraced part
    span_units: int = 0            # the units of the window's untraced part
    probes: dict = field(default_factory=dict)       # timings taken after the window
    launches: dict = field(default_factory=dict)     # kernel -> recorded calls, traced part
    latencies_s: list = field(default_factory=list)  # serve: every request of the window
    ref_flops_per_unit: Optional[float] = None       # the reference's FLOPs an image or a step
    peak_bf16_flops: float = roofline.BF16_FLOPS_PER_S

    @property
    def rate(self) -> float:
        return self.window_units / self.window_s

    @property
    def steady_rate(self) -> float:
        """Units a second over the untraced part of the window (the whole
        window when nothing was traced or nothing followed the trace)."""
        rest_s, rest = self.window_s - self.traced_wall_s, self.window_units - self.traced_units
        return rest / rest_s if rest > 0 and rest_s > 0 else self.rate


def host_load():
    """(process CPU seconds, the host's 1-minute load average): beside a
    window's wall time they tell the program's own work from waiting for a
    busy host."""
    t = os.times()
    return t.user + t.system, os.getloadavg()[0]


@dataclass
class Result:
    setup_s: float
    e2e: dict
    reading: Reading
    numbers: dict
    peak_bytes: Optional[int]
    notes: list = field(default_factory=list)


@contextlib.contextmanager
def reference_precision():
    """float32 without TF32 for the reference, the program's settings
    restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_cfg(cell, opts):
    from glass_tpu_torch.config import CfgNode, get_cfg

    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(cell.config["cfg"]))
    cfg.merge_from_list(list(opts))
    return cfg


def free():
    """Collect what the caller has let go of and return the device's cached
    blocks."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class HostSpans:
    """The benchmark's own host spans around calls into a layer: seconds
    and calls per name, for the whole window."""

    def __init__(self):
        self.spans = {}
        self.on = True  # off while the profiler runs: its overhead is not the layer's

    def wrap(self, name, fn):
        def timed(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                s = self.spans.setdefault(name, [0.0, 0])
                s[0] += time.perf_counter() - t0
                s[1] += 1
        return timed


class _Proxy:
    """The post-processor with its ``__call__`` timed and every other
    attribute its own."""

    def __init__(self, inner, timed_call):
        self._inner, self._call = inner, timed_call

    def __call__(self, *a, **k):
        return self._call(*a, **k)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _host_post_spans(runner, spans: HostSpans):
    """Time ``_model_postprocess`` and the post-processor of a runner: the
    host post-processing layer."""
    runner._model_postprocess = spans.wrap("host_post", runner._model_postprocess)
    runner.post_processor = _Proxy(runner.post_processor, spans.wrap("host_post", runner.post_processor))


def serving_inputs(cell, seed, dev, opts, mix):
    """What a serving cell hands both sides: the reference's configuration,
    the pool's scenes in the run's order, and the seeded weights on
    ``dev``, their batch-norm statistics calibrated by the reference on the
    pool's first scene; last, the seconds the reference took there, which
    set-up does not count."""
    rcfg = ref_config.load(cell.config["cfg"], opts)
    scenes, seq = traffic.scene_pool(mix, seed)
    sd = weights.seeded_state_dict(rcfg, cell.config["weights_seed"], dev, "serve")
    t0 = time.perf_counter()
    with reference_precision(), torch.no_grad():
        rr = RefRunner(rcfg, build_model(rcfg, sd, dev), dev)
        sd = weights.calibrate(rr, scenes[0])
    del rr
    free()
    return rcfg, [scenes[i] for i in seq], sd, time.perf_counter() - t0


def _serving_setup(cell, seed, dev, opts, mix):
    """The serving inputs and the program's runner, with the capture
    installed."""
    from glass_tpu_torch.inference import runner as runner_mod
    from glass_tpu_torch.models import glass_rcnn, rpn

    rcfg, pool, sd, ref_s = serving_inputs(cell, seed, dev, opts, mix)
    sd_host = {k: v.cpu() for k, v in sd.items()}
    runner = runner_mod.GlassRunner(cfg=program_cfg(cell, opts), state_dict=sd, device=dev)
    del sd
    free()
    cap = Capture(runner_mod, glass_rcnn, rpn, runner.model).install()
    return rcfg, pool, sd_host, runner, cap, ref_s


def _launch_recorder():
    return roofline.Launches().install()


def judge_serving(rcfg, sd_host, dev, path, pool, kept, returned, sample, index_of) -> dict:
    """The worst of each number over the compared answers ``sample``:
    ``kept`` what the capture kept of each, ``returned`` the instances the
    timed path returned, ``pool[index_of(i)]`` the scene of answer ``i``."""
    with reference_precision():
        rr = RefRunner(rcfg, build_model(rcfg, {k: v.to(dev) for k, v in sd_host.items()}, dev), dev)
        readings = [judge.judge_served(rr, path, pool[index_of(i)], kept[i], returned[i])
                    if i in kept and "out" in kept[i] and i in returned else judge.missing()
                    for i in sample]
    del rr
    free()
    return judge.worst(readings)


def _ref_flops_serving(rcfg, sd_host, dev, path, image):
    from torch.utils.flop_counter import FlopCounterMode

    with reference_precision(), torch.no_grad():
        rr = RefRunner(rcfg, build_model(rcfg, {k: v.to(dev) for k, v in sd_host.items()}, dev), dev)
        resized = rr.eval_resize(image)[0] if path == "eval" else rr.serve_resize(image)[0]
        with FlopCounterMode(display=False) as counter:
            rr.run_model(resized)
    del rr
    free()
    return float(counter.get_total_flops())


def run_eval_batch(cell, seed, seconds, trace, dev, t_start, opts, mix):
    rcfg, pool, sd_host, runner, cap, ref_s = _serving_setup(cell, seed, dev, opts, mix)
    bs, n_call = int(mix["batch_size"]), int(mix["images_per_call"])
    call_imgs = [pool[i % len(pool)] for i in range(n_call)]
    cap.restart({0})  # the warm-up keeps its first image: the shapes of the buffers to reserve
    runner.eval_batch_call(pool[:int(mix["warmup_images"])], batch_size=bs)
    sync(dev)
    sample = traffic.sample(seed, n_call, int(mix["compare"]))
    cap.reserve(len(sample))
    cap.restart(sample)
    spans = HostSpans()
    if trace:
        _host_post_spans(runner, spans)
        launches = _launch_recorder()
        traced = Traced(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start - ref_s

    cpu0, load0 = host_load()
    t0 = time.perf_counter()
    images = calls = 0
    first = None
    traced_units, traced_wall_s = 0, 0.0
    while True:
        tracing = trace and calls < int(mix["trace_calls"])
        if tracing:
            launches.on, spans.on = True, False
            traced.start()
        res = runner.eval_batch_call(call_imgs, batch_size=bs)
        if tracing:
            traced.stop()
            launches.on, spans.on = False, True
            traced_units += len(call_imgs)
            traced_wall_s = time.perf_counter() - t0
        if first is None:
            first = res
        images += len(res)
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    cpu1, load1 = host_load()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    reading = Reading("eval", window_s, images, host_spans=spans.spans, span_units=images - traced_units)
    if trace:
        reading.traced_units, reading.traced_wall_s = traced_units, traced_wall_s
        reading.trace = traced.summary(("glass.backbone", "glass.rpn", "glass.box_head",
                                        "glass.recognizer", "glass.mask_head"))
        reading.launches = launches.calls
        reading.probes["model_s_per_image"] = _probe_batch_model(runner, call_imgs[:bs], dev)
    cap.finish()
    kept, returned = cap.kept, {i: first[i] for i in sample}
    cap.remove()
    if trace:
        launches.remove()
    del runner, cap
    free()
    if trace:
        reading.ref_flops_per_unit = _ref_flops_serving(rcfg, sd_host, dev, "eval", pool[0])
    numbers = judge_serving(rcfg, sd_host, dev, "eval", call_imgs, kept, returned, sample, lambda i: i)
    return Result(setup_s, {"eval_img_s": images / window_s}, reading, numbers, peak,
                  [f"images {images} in {calls} calls of {n_call}; words returned by the compared "
                   f"images {int(numbers.get('words', 0))} at most",
                   f"window {window_s:.3f} s, process CPU {cpu1 - cpu0:.3f} s, host load {load0:.2f} -> {load1:.2f}"])


def _probe_batch_model(runner, images, dev, reps=3):
    """``batch_model_fn()`` on the cell's batch staged on the device, host
    clock ending in a synchronize: seconds an image."""
    from glass_tpu_torch.inference.runner import shortest_edge_size
    import cv2

    cfg = runner.cfg
    resized = []
    for im in images:
        nh, nw = shortest_edge_size(*im.shape[:2], cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
        resized.append(cv2.resize(im, (nw, nh)))
    bh = max(runner._pick_bucket(*r.shape[:2])[0] for r in resized)
    bw = max(runner._pick_bucket(*r.shape[:2])[1] for r in resized)
    batch = np.zeros((len(resized), bh, bw, 3), resized[0].dtype)
    hws = np.zeros((len(resized), 2), np.int32)
    for i, r in enumerate(resized):
        batch[i, :r.shape[0], :r.shape[1]] = r
        hws[i] = r.shape[:2]
    fn = runner.batch_model_fn()
    with torch.inference_mode():
        staged = torch.from_numpy(batch).to(dev)
        fn(staged, hws)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(staged, hws)
        sync(dev)
    return (time.perf_counter() - t0) / (reps * len(resized))


def _probe_single_model(runner, image, dev, reps=5):
    """``glass_inference_single`` on one padded image staged on the
    device (the serving path's model call), seconds a call."""
    from glass_tpu_torch.inference import runner as runner_mod

    h, w = image.shape[:2]
    bh, bw = runner._pick_bucket(h, w)
    padded = np.zeros((bh, bw, 3), np.float32)
    padded[:h, :w] = image
    with torch.inference_mode():
        staged = torch.from_numpy(padded).to(dev)
        runner_mod.glass_inference_single(runner.model, staged, (h, w))
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            runner_mod.glass_inference_single(runner.model, staged, (h, w))
        sync(dev)
    return (time.perf_counter() - t0) / reps


def run_serve_call(cell, seed, seconds, trace, dev, t_start, opts, mix):
    rcfg, pool, sd_host, runner, cap, ref_s = _serving_setup(cell, seed, dev, opts, mix)
    cap.restart({0})
    for i in range(int(mix["warmup_requests"])):
        runner(pool[i % len(pool)])
    sync(dev)
    sample = traffic.sample(seed, int(mix["compare_among"]), int(mix["compare"]))
    cap.reserve(len(sample))
    cap.restart(sample)
    spans = HostSpans()
    if trace:
        _host_post_spans(runner, spans)
        launches = _launch_recorder()
        traced = Traced(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start - ref_s

    lat, returned, traced_wall_s = [], {}, 0.0
    n_trace = int(mix["trace_requests"]) if trace else 0
    cpu0, load0 = host_load()
    t0 = time.perf_counter()
    while True:
        k = len(lat)
        if k == 0 and n_trace:
            launches.on, spans.on = True, False
            traced.start()
        t = time.perf_counter()
        preds = runner(pool[k % len(pool)])
        lat.append(time.perf_counter() - t)
        if k + 1 == n_trace:
            traced.stop()
            launches.on, spans.on = False, True
            traced_wall_s = time.perf_counter() - t0
        if k in cap.wanted:
            returned[k] = preds
        # the window ends with a whole pass over the pool: every seed then
        # sends each scene equally often, in its own order
        if (time.perf_counter() - t0 >= seconds and len(lat) % len(pool) == 0
                and len(lat) >= max(n_trace, int(mix["compare_among"]))):
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    cpu1, load1 = host_load()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    reading = Reading("serve", window_s, len(lat), host_spans=spans.spans, span_units=len(lat) - n_trace,
                      latencies_s=lat[n_trace:])
    if trace:
        reading.traced_units, reading.traced_wall_s = n_trace, traced_wall_s
        reading.trace = traced.summary(("glass.backbone", "glass.rpn", "glass.box_head",
                                        "glass.recognizer", "glass.mask_head"))
        reading.launches = launches.calls
        reading.probes["model_s_per_image"] = _probe_single_model(runner, pool[0], dev)
    cap.finish()
    kept = cap.kept
    cap.remove()
    if trace:
        launches.remove()
    del runner, cap
    free()
    if trace:
        reading.ref_flops_per_unit = _ref_flops_serving(rcfg, sd_host, dev, "serve", pool[0])
    numbers = judge_serving(rcfg, sd_host, dev, "serve", pool, kept, returned, sample,
                             lambda i: i % len(pool))
    p90 = float(np.percentile(np.asarray(lat), 90)) * 1e3
    quart = [round(float(q) * 1e3, 1) for q in np.percentile(np.asarray(lat), [25, 50, 75, 90, 95, 100])]
    return Result(setup_s, {"serve_p90_ms": p90}, reading, numbers, peak,
                  [f"requests {len(lat)}; p90 over all of them; p25 p50 p75 p90 p95 max ms {quart}; median "
                   f"{statistics.median(lat) * 1e3:.1f} ms; words returned by the compared requests "
                   f"{int(numbers.get('words', 0))} at most",
                   f"window {window_s:.3f} s, process CPU {cpu1 - cpu0:.3f} s, host load {load0:.2f} -> {load1:.2f}"])


def training_inputs(cell, seed, dev, opts, mix):
    """What the training cell hands both sides: the reference's
    configuration, the seeded weights on ``dev``, the mix's batches (host
    numpy) in the run's order, and the seed of the steps' random draws."""
    rcfg = ref_config.load(cell.config["cfg"], opts)
    sd = weights.seeded_state_dict(rcfg, cell.config["weights_seed"], dev, "train")
    pool, seq = traffic.train_pool(mix, seed, int(rcfg.TPU.MAX_GT_INSTANCES),
                                   int(rcfg.MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH))
    return rcfg, sd, [pool[i] for i in seq], int(seed) % (2 ** 31)


def reference_batch(batch: dict, dev) -> dict:
    """A host batch as the reference takes it."""
    return {k: (v if k == "content_hw" else torch.from_numpy(v).to(dev)) for k, v in batch.items()}


def judge_training(rcfg, sd, host_batches, prior_seed, calls, prog, mix, dev):
    """(numbers, the reference's readings) of a training run whose checked
    steps read ``prog`` and made the selection calls ``calls`` (a
    ``StepRecorder``'s): the reference's selection on each call's inputs,
    then the reference following the checked steps from the same weights,
    batches and draws with the recorded proposals."""
    n, b, size = int(mix["checked_steps"]), int(mix["batch"]), int(mix["size"])
    proposals = [[tuple(t.to(dev) for t in c["out"]) for c in calls[k * b:(k + 1) * b]] for k in range(n)]
    with reference_precision():
        numbers = {"proposals_off": _selection_off(rcfg, calls, (size, size), dev)}
        ref = ref_train.follow(rcfg, {k: v.to(dev) for k, v in sd.items()},
                               [reference_batch(x, dev) for x in host_batches[:n]], prior_seed, 0, proposals, dev)
    numbers.update(judge_train(prog, ref))
    return numbers, ref


def run_train_steps(cell, seed, seconds, trace, dev, t_start, opts, mix):
    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.parallel.mesh import make_parallel_train_loop
    from glass_tpu_torch.train import train_step as ts
    from glass_tpu_torch.train.optimizer import build_optimizer

    cfg = program_cfg(cell, opts)
    rcfg, sd, host_batches, prior_seed = training_inputs(cell, seed, dev, opts, mix)
    arch = GlassArch.from_config(cfg)
    sd_host = {k: v.cpu() for k, v in sd.items()}
    model = GlassRCNN(arch)
    model.load_state_dict(sd)
    model.to(dev)
    optimizer = build_optimizer(cfg, model)
    tcfg = ts.TrainConfig.from_config(cfg)
    batches = [ts.batch_to_device(x, dev) for x in host_batches]
    loop = make_parallel_train_loop(ts.train_step, 1)

    def step(it):
        return loop(model, optimizer, tcfg, batches[it % len(batches)],
                    lambda i: ts.Priorities(prior_seed, it + i, dev), it)

    # the checked steps: the window's own call and feed, rows that all differ
    n_check = int(mix["checked_steps"])
    rec = StepRecorder(ts).install()
    prog = {"losses": [], "dims": {n: p.dim() for n, p in model.named_parameters()}}
    for it in range(n_check):
        prog["losses"].append(float(step(it)["total_loss"]))
        if it == 0:
            # the first gradient as the optimizer took it: its momentum
            # buffer after one step (none if the step took nothing)
            first = {n: optimizer.sgd.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p))
                     for n, p in model.named_parameters()}
            prog["grads"], prog["grads_t"] = ref_train.leaf_norms(first), ref_train.on_host(first)
            del first
    prog["change_t"] = ref_train.on_host({n: p.detach() - sd[n] for n, p in model.named_parameters()})
    prog["change"] = ref_train.leaf_norms(prog["change_t"])
    rec.remove()
    del sd
    free()
    step(n_check)  # the window's first shapes again, past the checked steps
    sync(dev)
    if trace:
        launches = _launch_recorder()
        traced = Traced(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    it0 = it = n_check + 1
    traced_wall_s = 0.0
    n_trace = int(mix["trace_steps"]) if trace else 0
    cpu0, load0 = host_load()
    t0 = time.perf_counter()
    while True:
        if it == it0 and n_trace:
            launches.on = True
            traced.start()
        step(it)
        it += 1
        if it - it0 == n_trace:
            traced.stop()
            launches.on = False
            traced_wall_s = time.perf_counter() - t0
        if time.perf_counter() - t0 >= seconds and it - it0 >= n_trace:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    cpu1, load1 = host_load()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    steps = it - it0
    b = int(mix["batch"])
    reading = Reading("train", window_s, steps)
    if trace:
        reading.traced_units, reading.traced_wall_s = n_trace, traced_wall_s
        reading.trace = traced.summary(("glass.backbone", "glass.rpn_loss", "glass.rpn", "glass.box_head",
                                        "glass.recognizer", "glass.mask_head", "glass.backward",
                                        "glass.optimizer"))
        reading.launches = launches.calls
        launches.remove()
    del model, optimizer, loop, step
    free()

    numbers, ref = judge_training(rcfg, sd_host, host_batches, prior_seed, rec.calls, prog, mix, dev)
    if trace:
        reading.ref_flops_per_unit = _ref_step_flops(rcfg, sd_host, reference_batch(host_batches[0], dev),
                                                     prior_seed, [c["out"] for c in rec.calls[:b]], dev)
    return Result(setup_s, {"train_img_s": steps * b / window_s}, reading, numbers, peak,
                  [f"steps {steps} of batch {b}; checked steps' total losses program "
                   f"{prog['losses']} reference {ref['losses']}",
                   f"widest first-gradient gaps {worst_leaves(prog, ref, 'grads')}",
                   f"widest change gaps {worst_leaves(prog, ref, 'change')}",
                   f"widest groups: first gradient {widest_groups(prog, ref, 'grads')}, "
                   f"change {widest_groups(prog, ref, 'change')}",
                   f"window {window_s:.3f} s, process CPU {cpu1 - cpu0:.3f} s, host load {load0:.2f} -> {load1:.2f}"])


def _selection_off(rcfg, calls, image_hw, dev) -> int:
    """The reference's proposal selection on the program's recorded RPN
    outputs, against the program's proposals, worst call.  The anchors are
    the reference's own, for the levels of an ``image_hw`` input."""
    from ..reference.glass.models.fpn import FPN_LEVEL_STRIDES
    from ..reference.glass.models.glass_rcnn import GlassArch as RArch, GlassRCNN as RModel
    from ..reference.runner import f32_cfg

    arch = RArch.from_config(f32_cfg(rcfg))
    with torch.device("meta"):
        model = RModel(arch)
    h, w = image_hw
    anchors = []
    for i, f in enumerate(arch.rpn_in_features):
        s = FPN_LEVEL_STRIDES[f]
        anchors.append(model.anchors(i, -(-h // s), -(-w // s), dev))
    tol = [judge.BOX_TOL] * 5 + [judge.SCORE_TOL]
    worst = 0
    for c in calls:
        logits, deltas, content_hw, args = c["in"]
        if [lg.shape[0] for lg in logits] != [a.shape[0] for a in anchors]:
            raise ValueError("the recorded RPN outputs do not match the reference's anchors")
        out = ref_rpn.select_proposals_single_image(
            [lg.to(dev) for lg in logits], [d.to(dev) for d in deltas], anchors, content_hw, *args)
        pb, ps, pv = c["out"]
        got = judge.angle_free(judge.rows(pb, ps, pv))
        ref = judge.angle_free(judge.rows(out[0].cpu(), out[1].cpu(), out[2].cpu()))
        worst = max(worst, judge.unmatched(got, ref, tol))
    return worst


def _ref_step_flops(rcfg, sd_host, batch, prior_seed, props, dev):
    """FlopCounterMode's count of one reference training step (forward and
    backward) at the cell's shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.glass.train.train_step import Priorities, TrainConfig, glass_train_forward

    model = build_model(rcfg, {k: v.to(dev) for k, v in sd_host.items()}, dev).train()
    with reference_precision(), FlopCounterMode(display=False) as counter:
        total, _ = glass_train_forward(model, TrainConfig.from_config(rcfg), batch,
                                       Priorities(prior_seed, 0, dev),
                                       proposals=[tuple(t.to(dev) for t in p) for p in props])
        total.backward()
    del model, total
    free()
    return float(counter.get_total_flops())


def leaf_group(name: str, dim: int) -> str:
    """A leaf's parameter group: its component (the backbone's trunk, each
    FPN convolution kind, the RPN head, each ROI head and its parts) and
    whether it is a vector (a norm's scale or shift, a bias) or a
    weight."""
    comp = ".".join(name.split(".")[:2]).rstrip("0123456789")
    return f"{comp}:{'vector' if dim <= 1 else 'weight'}"


def _gaps(prog: dict, ref: dict, key: str, names) -> dict:
    """Each leaf's gap of norms, against the larger of the leaf's reference
    norm and the median leaf's."""
    med = statistics.median(ref[key][n] for n in names)
    return {n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med) for n in names}


def _diffs(prog: dict, ref: dict, key: str, names) -> dict:
    """Each leaf's norm of the difference of the two sides' tensors, against
    the larger of the leaf's reference norm and the median leaf's."""
    med = statistics.median(ref[key][n] for n in names)
    return {n: float(torch.linalg.norm((prog[key + "_t"][n] - ref[key + "_t"][n]).double())) / max(ref[key][n], med)
            for n in names}


def _group_medians(gaps: dict, dims: dict) -> dict:
    groups = {}
    for n, g in gaps.items():
        groups.setdefault(leaf_group(n, dims[n]), []).append(g)
    return {k: statistics.median(v) for k, v in groups.items()}


def _moved(ref: dict) -> list:
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more: the others move by round-off alone."""
    med = statistics.median(ref["grads"].values())
    return [n for n, r in ref["grads"].items() if r >= 1e-3 * med]


def judge_train(prog: dict, ref: dict) -> dict:
    """The numbers of the checked steps, each leaf's reading measured
    against the larger of that leaf's reference norm and the median
    leaf's; the change over the steps only of the leaves that move
    (``_moved``).

    * ``grad_gap``, ``change_gap``: the gap between the two sides' norms
      of a leaf's first gradient (as the optimizer took it: its momentum
      buffer after one step) and of its change, median leaf;
    * ``grad_gap_group``, ``change_gap_group``: the same, the median leaf
      of each parameter group (``leaf_group``), widest group: a wrong
      update of a group of leaves (every norm of the trunk, one head)
      shows, which the median over all leaves does not see;
    * ``grad_diff``, ``change_diff``: the norm of the difference of the
      two sides' tensors, median leaf; ``grad_diff_p10``: the first
      gradient's, the tenth-percentile leaf.  A gap of norms hardly sees
      rounding noise, which leaves a norm all but unchanged; a difference
      does.  In the median leaf, deep in the trunk, bfloat16's noise has
      already grown to a fifth of the gradient and float8's to over a
      half; the leaves nearest the loss keep it in proportion to
      the precision, so their tenth percentile is the number that tells
      float8 from bfloat16;
    * reported, not compared: ``loss_gap`` (the steps' total losses,
      widest relative gap) and the worst leaf's gaps (``grad_gap_worst``,
      ``change_gap_worst``: an early batch norm's scale or shift, which
      the reference in bfloat16 parts from itself in float32 by as much;
      ``PERF.md`` section 4).

    A step that leaves the state unchanged reads 1 on the change numbers
    and on the median leaf's differences."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    names, moved = list(ref["grads"]), _moved(ref)
    g, c = _gaps(prog, ref, "grads", names), _gaps(prog, ref, "change", moved)
    gd = sorted(_diffs(prog, ref, "grads", names).values())
    return {"loss_gap": loss_gap, "grad_gap": statistics.median(g.values()),
            "change_gap": statistics.median(c.values()),
            "grad_gap_group": max(_group_medians(g, ref["dims"]).values()),
            "change_gap_group": max(_group_medians(c, ref["dims"]).values()),
            "grad_diff": statistics.median(gd), "grad_diff_p10": gd[len(gd) // 10],
            "change_diff": statistics.median(_diffs(prog, ref, "change", moved).values()),
            "grad_gap_worst": max(g.values()), "change_gap_worst": max(c.values())}


def widest_groups(prog: dict, ref: dict, key: str, k: int = 3) -> list:
    """The ``k`` parameter groups with the widest median ``key`` gaps."""
    names = list(ref[key]) if key == "grads" else _moved(ref)
    meds = _group_medians(_gaps(prog, ref, key, names), ref["dims"])
    return sorted(meds.items(), key=lambda kv: -kv[1])[:k]


def worst_leaves(prog: dict, ref: dict, key: str, k: int = 4) -> list:
    """The ``k`` leaves with the widest ``key`` ("grads" or "change") gaps:
    (name, program norm, reference norm, gap)."""
    med = statistics.median(ref[key].values())
    gaps = sorted(((abs(prog[key][n] - r) / max(r, med), n) for n, r in ref[key].items()), reverse=True)[:k]
    return [(n, prog[key][n], ref[key][n], g) for g, n in gaps]


LOOPS = {"eval_batch": run_eval_batch, "serve_call": run_serve_call, "train_steps": run_train_steps}
