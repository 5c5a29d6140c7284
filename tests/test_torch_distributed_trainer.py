"""The port's ``Trainer`` and training CLI on two gloo ranks, on the CPU.

On the tiny synthetic set and small shapes of tests/test_torch_train_cli.py,
each rank: an IMS_PER_BATCH that does not divide over the ranks raises
glass_tpu's ValueError; two iterations at IMS_PER_BATCH 2 (one image a rank)
with a periodic ``test()`` at iteration 1, where each rank evaluates its
strided shard and the evaluator gathers them; then ``--resume`` on both
ranks for a third iteration.  Every rank must report the metrics one
process reports over all records with the same weights (the counterpart of
tests/test_multihost_semantics.py::test_trainer_periodic_eval_multihost,
with the real gather); rank 0 alone writes ``metrics.json`` and the
checkpoints; the replicas stay bit-identical.  ``python -m
glass_tpu_torch.train`` with TPU.TRAIN_DEVICES 2 on ``--device cpu``
spawns the two ranks itself.  ``agree_batch_shape`` pads each rank's
batch to the global batch's image size.
"""

import json
import os

import numpy as np
import pytest
import torch

from glass_tpu_torch.data import DatasetManager
from glass_tpu_torch.parallel import mesh
from glass_tpu_torch.train import cli
from glass_tpu_torch.train.trainer import Trainer
from test_torch_train_cli import CONFIG, SMALL, make_dataset
from torch_dist_workers import (
    DEADLINE_S, GROUP_TIMEOUT_S, THREADS, agree_shape_worker, load_ranks, remove_large_files, run_ranks,
    trainer_worker,
)

torch.set_num_threads(2)
EVAL = ["SOLVER.IMS_PER_BATCH", "2", "TEST.EVAL_PERIOD", "1", "TEST.PRECISE_BN.ENABLED", "False",
        "DATASETS.TEST", "['toy_train']", "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128",
        "TPU.IMAGE_BUCKETS", "[[96, 128]]"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_trainer"))
    ds = make_dataset(root)
    out = os.path.join(root, "out")
    argv = ["--config", CONFIG, "--datasets", ds, "--device", "cpu", *SMALL, *EVAL]
    run_ranks(trainer_worker, 2, (root, ["--output", out] + argv), root)
    ranks = load_ranks(root, 2)
    # one process, the same weights: the checkpoint of iteration 1
    cfg = cli.load_cfg(cli.parse_args(["--output", os.path.join(root, "single")] + argv))
    DatasetManager(cfg).register()
    single = Trainer(cfg, device="cpu")
    state = torch.load(os.path.join(out, "model_0000001.pth"), weights_only=False)["model"]
    single.model.load_state_dict(state)
    last = torch.load(os.path.join(out, "model_0000002.pth"), weights_only=False)["model"]
    checkpoints = sorted(n for n in os.listdir(out) if n.endswith(".pth"))
    remove_large_files(root)
    return dict(ranks=ranks, out=out, single=single.test(), checkpoints=checkpoints,
                last={k: last[k] for k in ranks[0]["state"]})


def test_indivisible_batch_raises(run):
    for r in run["ranks"]:
        assert "SOLVER.IMS_PER_BATCH=3 must be divisible by the data-mesh size (2 devices)" in r["indivisible"]


def test_periodic_eval_gathers_every_rank(run):
    """Every rank's periodic ``test()`` inside ``train`` reports the single
    process's metrics over all records."""
    single = run["single"]["toy_train"]
    want = {f"toy_train/{g}/{k}": v for g, vals in single.items() for k, v in vals.items()}
    assert want
    for r in run["ranks"]:
        assert {k: it_v[1] for k, it_v in r["periodic"].items()} == want
        assert all(it_v[0] == 1 for it_v in r["periodic"].values())
        assert r["scored"] == [["1", "2", "3", "4"]]  # each rank scored every image


def test_rank0_alone_writes_metrics_and_checkpoints(run):
    assert [r["writes_metrics"] for r in run["ranks"]] == [True, False]
    with open(os.path.join(run["out"], "metrics.json")) as f:
        iters = [json.loads(line)["iteration"] for line in f]
    assert iters and len(iters) == len(set(iters)), iters  # one writer: no line twice
    with open(os.path.join(run["out"], "last_checkpoint")) as f:
        assert f.read().strip() == "model_0000002.pth"
    assert run["checkpoints"] == ["model_0000001.pth", "model_0000002.pth"]


def test_resume_on_both_ranks(run):
    assert [r["start_iter"] for r in run["ranks"]] == [2, 2]
    assert all(r["agree"] for r in run["ranks"])
    for k, v in run["ranks"][0]["state"].items():
        assert torch.equal(run["last"][k], v), k


def test_agree_batch_shape_pads_to_the_global_size(tmp_path):
    rng = np.random.RandomState(0)
    batches = [{"images": rng.rand(1, h, w, 3).astype(np.float32), "content_hw": np.array([[h, w]])}
               for h, w in ((64, 96), (96, 64))]
    run_ranks(agree_shape_worker, 2, (str(tmp_path), batches), tmp_path)
    for b, got in zip(batches, load_ranks(str(tmp_path), 2)):
        img = got["images"].numpy()
        h, w = b["images"].shape[1:3]
        assert img.shape == (1, 96, 96, 3)
        np.testing.assert_array_equal(img[:, :h, :w], b["images"])
        assert not img[:, h:].any() and not img[:, :, w:].any()


def test_cli_spawns_one_rank_per_device(tmp_path, monkeypatch):
    """TPU.TRAIN_DEVICES 2 on --device cpu: two gloo ranks, spawned by the
    CLI (here with the tests' rendezvous and limits)."""
    root = str(tmp_path)
    ds = make_dataset(root)
    out = os.path.join(root, "out")
    launch = mesh.launch
    calls = []

    def bounded(worker, world, **kw):
        calls.append((world, kw["device"]))
        kw.update(init_method=f"file://{root}/pg", timeout_s=GROUP_TIMEOUT_S, deadline_s=DEADLINE_S,
                  threads=THREADS)
        launch(worker, world, **kw)

    monkeypatch.setattr(mesh, "launch", bounded)
    got = cli.main(["--config", CONFIG, "--datasets", ds, "--output", out, "--device", "cpu",
                    "--max-iter", "1", *SMALL, "SOLVER.IMS_PER_BATCH", "2", "TPU.TRAIN_DEVICES", "2"])
    assert got is None and calls == [(2, "cpu")]
    assert os.path.exists(os.path.join(out, "log.txt")) and os.path.exists(os.path.join(out, "log.txt.rank1"))
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().strip() == "model_0000000.pth"
    with open(os.path.join(out, "metrics.json")) as f:
        (line,) = f.read().splitlines()
    assert np.isfinite(json.loads(line)["total_loss"])
    remove_large_files(root)
