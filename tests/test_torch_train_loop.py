"""``TPU.TRAIN_LOOP_STEPS`` in the port, on the CPU.

glass_tpu runs K steps as one jitted ``lax.scan`` (``make_parallel_train_
scan``, the Trainer's ``_train_chunked``), each step's key folding its
global iteration, so the chunked loop is step for step the one-step loop.
The port's one loop (``Trainer.train``) runs chunks of up to K steps as a
host loop over its step (K = 1 is one step a chunk) with the metrics kept
on the device; everything here is compared bit for bit:

* ``Trainer.chunk_len`` against glass_tpu's over tests/test_train_loop.py's
  grid of periods, starts and lengths, at every iteration;
* a ``Trainer`` with ``TRAIN_LOOP_STEPS`` 3 over 5 iterations against K = 1
  from the same seed, with a checkpoint period (3), an evaluation period
  (2) and a VIS period (3) that split chunks ([3, 1, 1]): the parameters
  and buffers, the ``metrics.json`` lines (``data_time``, a wall clock,
  aside), the checkpoint files and their contents, the VIS dumps and the
  iterations the evaluation ran at;
* ``make_parallel_train_scan``'s contract, on a recording step: step j
  gets batch j, priorities j and iteration j, in order, and each metric
  comes back stacked.
"""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from glass_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

from glass_tpu_torch.parallel import mesh  # noqa: E402
from glass_tpu_torch.train import main  # noqa: E402
from glass_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_train_cli import CONFIG, SMALL, make_dataset  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("loop_k", [2, 3, 8])
def test_chunk_len_is_glass_tpus(loop_k):
    for ckpt, ev, vis in [(0, 0, 0), (5, 0, 0), (0, 4, 0), (0, 0, 3), (5, 4, 3), (1, 1, 1), (7, 5, 2)]:
        for start, max_iter in [(0, 17), (3, 11), (10, 10)]:
            for it in range(start, max_iter):
                args = (it, max_iter, loop_k, ckpt, ev, vis)
                assert Trainer.chunk_len(*args) == JTrainer.chunk_len(*args), args


def _train(root, ds, loop_k, monkeypatch):
    """5 iterations of the CLI; returns the trainer, the output dir and the
    iterations the periodic evaluation ran at."""
    evals = []
    monkeypatch.setattr(Trainer, "test", lambda self, max_images=None: evals.append(self.storage.iter))
    out = os.path.join(root, f"k{loop_k}")
    trainer = main(["--config", CONFIG, "--datasets", ds, "--output", out, "--device", "cpu",
                    "--max-iter", "5", *SMALL, "SEED", "11", "TPU.TRAIN_LOOP_STEPS", str(loop_k),
                    "SOLVER.CHECKPOINT_PERIOD", "3", "TEST.EVAL_PERIOD", "2", "VIS_PERIOD", "3"])
    return trainer, out, evals


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loop"))
    ds = make_dataset(root)
    with pytest.MonkeyPatch.context() as mp:
        runs = {k: _train(root, ds, k, mp) for k in (1, 3)}
    yield runs
    for _, out, _ in runs.values():
        for name in os.listdir(out):
            if name.endswith(".pth"):
                os.remove(os.path.join(out, name))


def _same(a, b) -> bool:
    """Bit-for-bit equality of nested dicts, lists and tensors."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_same(v, b[k]) for k, v in a.items())
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _metrics_lines(out):
    with open(os.path.join(out, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        row.pop("data_time", None)
    return [list(row.items()) for row in rows]


def test_chunked_trainer_ends_with_the_same_state(trained):
    (one, _, _), (chunked, _, _) = trained[1], trained[3]
    assert chunked.cfg.TPU.TRAIN_LOOP_STEPS == 3
    sd1, sd3 = one.model.state_dict(), chunked.model.state_dict()
    assert set(sd1) == set(sd3)
    differ = [k for k, v in sd1.items() if not torch.equal(v, sd3[k])]
    assert not differ, differ


def test_chunked_trainer_writes_the_same_files(trained):
    (_, out1, evals1), (_, out3, evals3) = trained[1], trained[3]
    assert _metrics_lines(out3) == _metrics_lines(out1)
    files = sorted(n for n in os.listdir(out1) if n != "log.txt")
    assert files == sorted(n for n in os.listdir(out3) if n != "log.txt")
    assert [n for n in files if n.endswith(".pth")] == ["model_0000003.pth", "model_0000004.pth"]
    assert [n for n in files if n.startswith("vis_")] == ["vis_0000000.png", "vis_0000003.png"]
    assert evals1 == evals3 == [2, 4]
    for name in files:
        if name.endswith(".pth"):
            a = torch.load(os.path.join(out1, name), map_location="cpu", weights_only=False)
            b = torch.load(os.path.join(out3, name), map_location="cpu", weights_only=False)
            assert a["iteration"] == b["iteration"]
            assert _same(a["model"], b["model"]) and _same(a["optimizer"], b["optimizer"]), name
        elif name != "metrics.json":  # compared above, data_time aside
            with open(os.path.join(out1, name), "rb") as f1, open(os.path.join(out3, name), "rb") as f3:
                assert f1.read() == f3.read(), name


def test_chunks_split_on_the_side_effects():
    assert [Trainer.chunk_len(it, 5, 3, 3, 2, 3) for it in (0, 3, 4)] == [3, 1, 1]


def test_scan_runs_each_step_in_order_and_stacks_its_metrics():
    calls = []

    def step(model, optimizer, tcfg, batch, priorities, iteration):
        calls.append((model, optimizer, tcfg, batch, priorities, iteration))
        return {"loss": torch.tensor(float(batch) + 0.5 * iteration), "n": torch.tensor(iteration)}

    got = mesh.make_parallel_train_scan(step)("m", "o", "t", [10, 20, 30], ["p4", "p5", "p6"], [4, 5, 6])
    assert calls == [("m", "o", "t", 10, "p4", 4), ("m", "o", "t", 20, "p5", 5), ("m", "o", "t", 30, "p6", 6)]
    assert set(got) == {"loss", "n"}
    assert torch.equal(got["loss"], torch.tensor([12.0, 22.5, 33.0]))
    assert torch.equal(got["n"], torch.tensor([4, 5, 6]))
