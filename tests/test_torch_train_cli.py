"""``python -m glass_tpu_torch.train`` on the CPU: two steps on a tiny
synthetic set at small shapes (``SMALL``: 64-96 px images, RPN top-k
64/16, 32 RoIs, 2 words of 5 characters), ``metrics.json`` and the
checkpoint in detectron2's layout, ``--resume``, glass_tpu reading the
port's ``.pth``, and the port's loader against glass_tpu's for the same
seed."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.config import merge_from_dataset_config as j_merge_datasets
from glass_tpu.data import DatasetManager as JDatasetManager
from glass_tpu.data import DatasetMapper as JDatasetMapper
from glass_tpu.data import build_train_loader as j_build_train_loader
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict, load_torch_checkpoint

from glass_tpu_torch.config import get_cfg, merge_from_dataset_config
from glass_tpu_torch.train import main
from glass_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "glass_finetune_icdar15.yaml")
SMALL = ["SOLVER.IMS_PER_BATCH", "1", "SOLVER.CHECKPOINT_PERIOD", "0",
         "INPUT.MIN_SIZE_TRAIN", "(64, 80)", "INPUT.MAX_SIZE_TRAIN", "96",
         "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "16",
         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "5",
         "MODEL.ROI_RECOGNIZER_HEAD.MAX_BATCH_SIZE", "2", "TPU.MAX_GT_INSTANCES", "8",
         "TEST.DETECTIONS_PER_IMAGE", "8", "TEST.EVAL_PERIOD", "0"]


def make_dataset(root, n_images=4):
    """COCO-style words on noise (rotated_box, rec, angle, orientation,
    segmentation), as tests/test_trainer_integration.py writes them."""
    ds = os.path.join(root, "ds", "toy_train")
    os.makedirs(ds)
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(n_images):
        h, w = 80, 96
        cv2.imwrite(os.path.join(ds, f"img_{i}.png"), (rng.rand(h, w, 3) * 255).astype(np.uint8))
        images.append({"id": i + 1, "file_name": f"img_{i}.png", "height": h, "width": w})
        for _ in range(2):
            cx, cy = rng.uniform(25, w - 25), rng.uniform(20, h - 20)
            bw, bh = rng.uniform(16, 30), rng.uniform(8, 12)
            quad = [[cx - bw / 2, cy - bh / 2], [cx + bw / 2, cy - bh / 2],
                    [cx + bw / 2, cy + bh / 2], [cx - bw / 2, cy + bh / 2]]
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                         "bbox": [cx - bw / 2, cy - bh / 2, bw, bh], "rotated_box": quad,
                         "segmentation": [[c for pt in quad for c in pt]], "rec": "hi", "angle": 0,
                         "orientation": 0, "area": bw * bh, "iscrowd": 0})
    with open(os.path.join(ds, "annotations.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "word"}]}, f)
    path = os.path.join(root, "datasets.yaml")
    with open(path, "w") as f:
        f.write(f"ROOT: {os.path.join(root, 'ds')}\nDATASETS:\n  - toy_train\nVAL_DATASETS: []\n")
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train"))
    ds = make_dataset(root)
    out = os.path.join(root, "out")
    args = ["--config", CONFIG, "--datasets", ds, "--output", out, "--device", "cpu"]
    trainer = main(args + ["--max-iter", "2", *SMALL])
    return dict(root=root, ds=ds, out=out, args=args, trainer=trainer)


def test_two_steps_write_metrics_and_checkpoint(trained):
    out = trained["out"]
    with open(os.path.join(out, "last_checkpoint")) as f:
        name = f.read().strip()
    assert name == "model_0000001.pth"
    data = torch.load(os.path.join(out, name), map_location="cpu", weights_only=False)
    assert set(data) == {"model", "optimizer", "iteration"} and data["iteration"] == 1
    with open(os.path.join(out, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    first = rows[0]
    assert first["iteration"] == 0 and first["lr"] > 0
    losses = {k: v for k, v in first.items() if k.startswith("loss")}
    assert {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_orientation",
            "loss_decoder", "loss_mask"} <= set(losses)
    assert all(np.isfinite(v) for v in first.values())
    assert os.path.exists(os.path.join(out, "vis_0000000.png"))  # VIS_PERIOD 500 dumps iteration 0
    model = trained["trainer"].model
    for k, v in model.state_dict().items():  # the checkpoint holds the trained weights
        assert torch.equal(data["model"][k], v), k


def test_resume_goes_on_at_iteration_two(trained):
    trainer = main(trained["args"] + ["--resume", "--max-iter", "3", *SMALL])
    assert trainer.start_iter == 2
    with open(os.path.join(trained["out"], "last_checkpoint")) as f:
        assert f.read().strip() == "model_0000002.pth"


def test_glass_tpu_reads_the_port_checkpoint(trained):
    path = os.path.join(trained["out"], "model_0000001.pth")
    tree = load_torch_checkpoint(path)
    state = torch.load(path, map_location="cpu", weights_only=False)["model"]
    want = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in state.items()}))

    def leaves(t, prefix=()):
        for k, v in t.items():
            yield from (leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])

    got = dict(leaves(tree))
    ref = dict(leaves(want))
    assert set(got) == set(ref) and len(got) > 300
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=".".join(k))


def test_loader_yields_glass_tpu_batches(trained):
    cfg = get_cfg(CONFIG)
    merge_from_dataset_config(cfg, trained["ds"])
    cfg.merge_from_list(SMALL + ["SOLVER.IMS_PER_BATCH", "2", "SEED", "7"])
    cfg.OUTPUT_DIR = os.path.join(trained["root"], "loader")
    port = iter(Trainer(cfg, device="cpu").build_train_loader())
    jcfg = j_get_cfg(CONFIG)
    j_merge_datasets(jcfg, trained["ds"])
    jcfg.merge_from_list(SMALL + ["SOLVER.IMS_PER_BATCH", "2", "SEED", "7"])
    JDatasetManager(jcfg).register()
    records = [r for name in jcfg.DATASETS.TRAIN for r in JDatasetManager.load(name)]
    mapper = JDatasetMapper(jcfg, is_train=True, rng=np.random.RandomState(7))
    theirs = j_build_train_loader(jcfg, records, mapper, batch_size=2, seed=7)
    for _ in range(2):
        a, b = next(port), next(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_partial_weights_overlay_keeps_the_rest(trained, tmp_path):
    """``--weights``/``MODEL.WEIGHTS``: names that match in shape load, a
    wrong shape and an unknown name are skipped, the rest keep their init."""
    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.train.checkpoint import load_weights_

    model = GlassRCNN(GlassArch())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    stem = "backbone.bottom_up.stem.conv1.weight"
    fc1 = "roi_heads.box_head.fc1.bias"
    part = {stem: torch.ones_like(before[stem]), fc1: torch.ones(3), "not.in.model": torch.ones(2)}
    path = str(tmp_path / "part.pth")
    torch.save({"model": part}, path)
    load_weights_(model, path)
    after = model.state_dict()
    assert torch.equal(after[stem], part[stem])
    assert all(torch.equal(after[k], before[k]) for k in before if k != stem)


def test_sigterm_checkpoints_and_exits(trained, monkeypatch):
    """A SIGTERM during training checkpoints the current iteration and
    returns (the reference's preemption safety)."""
    import signal

    from glass_tpu_torch.train import trainer as trainer_mod

    real = trainer_mod.train_step

    def step_then_signal(*a, **k):
        out = real(*a, **k)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(trainer_mod, "train_step", step_then_signal)
    out = os.path.join(trained["root"], "sigterm")
    try:
        trainer = main(["--config", CONFIG, "--datasets", trained["ds"], "--output", out, "--device", "cpu",
                        "--max-iter", "5", *SMALL])
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.default_int_handler)
    assert trainer._last_saved_iter == 0
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().strip() == "model_0000000.pth"


def test_periodic_eval_runs_the_port_runner_after_precise_bn(trained):
    """``Trainer.test``: precise BN over train batches (the EMA inverted, so
    the running statistics become the batches' average statistics), then
    the port's GlassRunner and RRC evaluator on DATASETS.TEST."""
    from glass_tpu_torch.models.context import BatchNorm2d

    cfg = get_cfg(CONFIG)
    merge_from_dataset_config(cfg, trained["ds"])
    cfg.merge_from_list(SMALL + ["TEST.PRECISE_BN.ENABLED", "True", "TEST.PRECISE_BN.NUM_ITER", "2",
                                 "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128",
                                 "TPU.IMAGE_BUCKETS", "[[96, 128]]"])
    cfg.DATASETS.TEST = ["toy_train"]
    cfg.OUTPUT_DIR = os.path.join(trained["root"], "eval")
    trainer = Trainer(cfg, device="cpu")
    bn = next(m for m in trainer.model.modules() if isinstance(m, BatchNorm2d))
    before = bn.running_var.clone()
    results = trainer.test(max_images=2)
    assert not torch.equal(bn.running_var, before) and torch.isfinite(bn.running_var).all()
    assert set(results) == {"toy_train"} and results["toy_train"]
    assert trainer.model.training  # back to training mode after the eval


def test_cli_module_refuses_distributed(trained, tmp_path):
    """``--distributed`` is ported: ``python -m glass_tpu_torch.train
    --distributed --device cpu`` joins the one-rank gloo group the
    environment describes (torchrun's variables) and trains a step."""
    from glass_tpu_torch.parallel.mesh import free_port

    out = str(tmp_path / "dist")
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-m", "glass_tpu_torch.train", "--config", CONFIG,
                           "--datasets", trained["ds"], "--output", out, "--distributed", "--device", "cpu",
                           "--max-iter", "1", *SMALL], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().strip() == "model_0000000.pth"
    with open(os.path.join(out, "metrics.json")) as f:
        assert np.isfinite(json.loads(f.readline())["total_loss"])
    os.remove(os.path.join(out, "model_0000000.pth"))  # several hundred MB
