"""The port's measurement entry points (``glass_tpu_torch.bench`` and
``glass_tpu_torch.tools``), on the CPU.

* Same workload as glass_tpu's tools: the benchmark configuration equals
  bench.py's and tools/e2e_breakdown.py's (the overrides they assign,
  read from their source, and ``GLASS_BENCH_OPTS``); ``train_bench.
  make_batch`` equals tools/train_bench.py's array for array (the
  polygons are each package's own ``boxes_to_polygons`` of the same boxes:
  equal within a thousandth of a pixel, the rest bit for bit);
  ``sustained_eval.make_dataset`` writes the same JSON and image bytes;
  bench's seeded images and e2e_breakdown's staged batch are glass_tpu's.
* The FLOP count of a conv-only stage (the backbone at 64x64) is 2 * MACs
  summed over its convolutions, taken here from the modules' shapes; the
  peak table names the H100 and refuses another card.
* Each tool runs: ``--device cpu`` at a tiny size prints its JSON line
  with its keys, labelled a CPU run, with no device metric; without a
  card, each refuses the default ``cuda``.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg

from glass_tpu_torch import bench
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.models import glass_rcnn as gr
from glass_tpu_torch.tools import (
    backbone_bwd_breakdown,
    common,
    e2e_breakdown,
    mfu_breakdown,
    profile_breakdown,
    serve_ab,
    sustained_eval,
    train_bench,
    train_mfu_breakdown,
)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = ["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "224", "TPU.IMAGE_BUCKETS", "[[64,224]]",
         "MODEL.RPN.PRE_NMS_TOPK_TEST", "32", "MODEL.RPN.POST_NMS_TOPK_TEST", "8",
         "TEST.DETECTIONS_PER_IMAGE", "2", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "4",
         "TPU.COMPUTE_DTYPE", "float32"]
TRAIN = ["MODEL.RPN.PRE_NMS_TOPK_TRAIN", "32", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "8",
         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "5",
         "MODEL.ROI_RECOGNIZER_HEAD.MAX_BATCH_SIZE", "1", "TPU.MAX_GT_INSTANCES", "8",
         "TPU.COMPUTE_DTYPE", "float32"]
HW = ["--hw", "64", "224"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assigned_overrides(path, func):
    """The ``cfg.A.B = <constant>`` assignments in ``func`` of ``path``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute):
            target = ast.unparse(node.targets[0])
            if target.startswith("cfg."):
                out.append((target[len("cfg."):], ast.literal_eval(node.value)))
    return out


def _glass_tpu_bench_cfg(path, func):
    cfg = j_get_cfg(os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml"))
    for dotted, value in _assigned_overrides(path, func):
        node = cfg
        *parents, leaf = dotted.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    env = os.environ.get("GLASS_BENCH_OPTS", "").split()
    if env:
        cfg.merge_from_list(env)
    return cfg


@pytest.mark.parametrize("env", ["", "TPU.SERVE_BATCH_MODE vmap POST_PROCESSING.ON_DEVICE True"])
@pytest.mark.parametrize("path,func", [("bench.py", "_run"), ("tools/e2e_breakdown.py", "build")])
def test_bench_config_is_glass_tpus(monkeypatch, path, func, env):
    monkeypatch.setenv("GLASS_BENCH_OPTS", env)
    want = _glass_tpu_bench_cfg(path, func)
    assert len(_assigned_overrides(path, func)) == 7
    assert json.dumps(common.bench_cfg(), sort_keys=True, default=str) == json.dumps(want, sort_keys=True,
                                                                                     default=str)


def test_train_bench_batch_is_glass_tpus():
    jtb = _load("tools/train_bench.py", "glass_tpu_train_bench")
    args = (2, 256, 320, 24, 64, 25)
    want, got = jtb.make_batch(*args), train_bench.make_batch(*args)
    assert list(got) == list(want)
    for k, v in want.items():
        w = np.asarray(v)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if k == "gt_polygons":
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-3)
        else:
            assert np.array_equal(got[k], w), k


def test_sustained_eval_writes_glass_tpus_dataset(tmp_path):
    jse = _load("tools/sustained_eval.py", "glass_tpu_sustained_eval")
    jse.make_dataset(str(tmp_path / "a"), "s", 3, h=64, w=224)
    sustained_eval.make_dataset(str(tmp_path / "b"), "s", 3, h=64, w=224)
    names = sorted(os.listdir(tmp_path / "a" / "s"))
    assert names == sorted(os.listdir(tmp_path / "b" / "s")) and len(names) == 4
    for n in names:
        assert (tmp_path / "a" / "s" / n).read_bytes() == (tmp_path / "b" / "s" / n).read_bytes(), n


def test_bench_images_and_staged_batch_are_glass_tpus():
    """bench.py draws the model-only frame (736x1280), then four 720x1280
    images, from one RandomState(0); e2e_breakdown stages its own four."""
    rng = np.random.RandomState(0)
    frame = (rng.rand(736, 1280, 3) * 255).astype(np.uint8)
    four = [(rng.rand(720, 1280, 3) * 255).astype(np.uint8) for _ in range(4)]
    got_frame, got_four = bench.bench_images()
    assert np.array_equal(got_frame, frame)
    assert all(np.array_equal(a, b) for a, b in zip(got_four, four)) and len(got_four) == 4

    class Bucketing:  # what staging reads of a runner, at the bench config
        cfg = common.bench_cfg()
        min_target_size, max_target_size = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
        buckets = [tuple(b) for b in cfg.TPU.IMAGE_BUCKETS]
        pad_multiple = cfg.TPU.PAD_IMAGE_TO_MULTIPLE
        device = torch.device("cpu")

    from glass_tpu_torch.inference import GlassRunner

    Bucketing._pick_bucket = GlassRunner._pick_bucket
    jeb = _load("tools/e2e_breakdown.py", "glass_tpu_e2e_breakdown")
    j_padded, _, j_hws = jeb.staged_batch(Bucketing(), 4)
    images, padded, on_device, hws = e2e_breakdown.staged_batch(Bucketing(), 4)
    assert padded.shape == (4, 960, 1600, 3)
    assert np.array_equal(padded, np.asarray(j_padded)) and np.array_equal(hws, j_hws)
    assert torch.equal(on_device, torch.from_numpy(padded))


def test_flop_count_of_the_backbone_is_twice_its_macs():
    model = GlassRCNN(GlassArch(compute_dtype="float32")).eval()
    norm = torch.from_numpy(np.random.RandomState(0).randn(64, 64, 3).astype(np.float32))
    macs = []

    def hook(mod, inputs, out):
        cin, kh, kw = mod.weight.shape[1:]
        macs.append(out.numel() * cin * kh * kw)

    handles = [m.register_forward_hook(hook) for m in model.backbone.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        gr.backbone_features(model, norm)
        n_convs = len(macs)
        macs.clear()
        flops = common.count_flops(lambda: gr.backbone_features(model, norm))
    for h in handles:
        h.remove()
    assert n_convs == 53 + 8  # ResNet-50 (stem, 16 blocks of 3, 4 shortcuts) + FPN (4 lateral, 4 output)
    assert flops == 2 * sum(macs) > 0


def test_peak_table():
    assert common.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert common.peak_flops("NVIDIA H100 80GB HBM3", "float16") == 989e12
    assert common.peak_flops("NVIDIA H100 80GB HBM3", "tf32") == 495e12
    assert common.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    with pytest.raises(KeyError, match="no published peak"):
        common.peak_flops("NVIDIA A100-SXM4-80GB", "bfloat16")
    assert common.mfu(1e12, 10.0, torch.device("cpu"), "bfloat16") is None


TOOLS = {
    "bench": (bench.main, ["--device", "cpu", *HW, "--frames", "1", "--rounds", "1", "--windows", "1",
                           "--train-size", "64", "--train-steps", "1", "--train-opts", *TRAIN]),
    "e2e_breakdown": (e2e_breakdown.main, ["--device", "cpu", "--rounds", "1", "--batch", "2", *HW, *SERVE]),
    "train_bench": (train_bench.main, ["--device", "cpu", "--size", "64", "--steps", "2", "--windows", "2",
                                       "--flops", "--opts", *TRAIN]),
    "train_bench_dispatched": (train_bench.main, ["--device", "cpu", "--size", "64", "--steps", "1",
                                                  "--dispatched", "--opts", *TRAIN]),
    "sustained_eval": (sustained_eval.main, ["--device", "cpu", "--images", "5", "--batch", "1", *HW, *SERVE]),
    "profile_breakdown": (profile_breakdown.main, ["--device", "cpu", "--k", "1", *HW, "--opts", *SERVE, "--",
                                                   "topk_p2", "topk_all5", "nms256", "select_proposals",
                                                   "stage_crops", "stage_global_pool", "stage_decode",
                                                   "stage_full"]),
    "mfu_breakdown": (mfu_breakdown.main, ["serve", "--device", "cpu", "--k", "1", *HW, "--opts", *SERVE]),
    "train_mfu_breakdown": (train_mfu_breakdown.main, ["--device", "cpu", "--steps", "1", "--trials", "1",
                                                       "--size", "64", "--extra-opts", *TRAIN]),
    "backbone_bwd_breakdown": (backbone_bwd_breakdown.main, ["--device", "cpu", "--size", "64", "--k", "1",
                                                             "--trials", "1"]),
    "serve_ab": (serve_ab.main, ["--device", "cpu", "--frames", "1", *HW, *SERVE]),
}
KEYS = {
    "bench": {"metric", "value", "unit", "vs_baseline", "detail"},
    "e2e_breakdown": {"device", "model_ms_per_img", "fetch_ms_per_img", "host_ms_per_img", "pipelined_ms_per_img",
                      "rounds_ms", "e2e_ips", "serve_batch_mode", "on_device_merge"},
    "train_bench": {"device", "ms_per_step", "ips_per_chip", "flops", "mfu", "loop"},
    "train_bench_dispatched": {"device", "ms_per_step", "ips_per_chip", "loop"},
    "sustained_eval": {"device", "steady_state_ips", "first50_ips", "last50_ips", "rate_drift_pct", "peak_rss_mb",
                       "rss_growth_mb", "max_memory_allocated_mib"},
    "profile_breakdown": {"device", "k", "ms"},
    "mfu_breakdown": {"device", "mfu_table"},
    "train_mfu_breakdown": {"device", "train_mfu_table", "medians_ms"},
    "backbone_bwd_breakdown": {"device", "stages", "conv_witness"},
    "serve_ab": {"device", "ms_per_frame", "best_ips"},
}


def _device_metrics(name, out):
    """The values only a card gives, each of which a CPU run leaves None."""
    if name == "bench":
        d = out["detail"]
        return [d["serve_model_mfu"], d["serve_model_mfu_b4"], d["train_mfu"], d["e2e_split"]["device_ms_per_img"],
                d["e2e_split"]["device_busy_share"]]
    if name == "e2e_breakdown":
        return [out["rounds_ms"]["device_ms"], out["rounds_ms"]["device_busy_share"]]
    if name == "train_bench":
        return [out["mfu"]]
    if name == "sustained_eval":
        return [out["max_memory_allocated_mib"]]
    if name in ("mfu_breakdown", "train_mfu_breakdown"):
        return [r["mfu"] for r in out["mfu_table" if name == "mfu_breakdown" else "train_mfu_table"]]
    if name == "backbone_bwd_breakdown":
        w = out["conv_witness"]
        return ([r[key] for r in out["stages"] for key in r if "mfu" in key or "device" in key]
                + [w[key] for key in w if "device" in key])
    return []


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_cpu(name, capsys, monkeypatch):
    monkeypatch.setenv("GLASS_BENCH_OPTS", " ".join(SERVE))  # bench's serving config
    main, argv = TOOLS[name]
    out = main(argv)
    captured = capsys.readouterr()
    printed = json.loads(captured.out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert KEYS[name] <= set(out), KEYS[name] - set(out)
    device = out["detail"]["device"] if name == "bench" else out["device"]
    assert device["platform"] == "cpu"
    assert all(v is None for v in _device_metrics(name, out))
    if name == "bench":
        assert out["metric"] == "e2e_spotting_images_per_sec_cpu_run" and out["vs_baseline"] is None
        assert out["value"] == out["detail"]["e2e_device_resident_b4_ips"] > 0
        assert out["detail"]["serve_flops"] > 0 and out["detail"]["train_flops"] > 0
    if name == "profile_breakdown":
        assert {"stage_crops", "stage_global_pool"} <= set(out["ms"])
    if name == "train_bench":
        assert out["loop"] == "make_parallel_train_loop" and len(out["window_ms_per_step"]) == 2
        assert np.isfinite(out["last_total_loss"]) and out["flops"] > 0
    if name == "train_bench_dispatched":  # an alias: glass_tpu's two forms are one host loop here
        assert out["loop"] == "make_parallel_train_loop" and "already dispatches" in captured.err


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_refuses_the_card_without_one(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = TOOLS[name]
    i = argv.index("--device")
    with pytest.raises(RuntimeError, match="is_available"):
        main(argv[:i] + argv[i + 2:])
