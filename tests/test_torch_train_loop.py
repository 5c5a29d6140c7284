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


# ---- make_parallel_train_loop: n steps on one batch ------------------------

def test_loop_runs_n_steps_on_one_batch_and_returns_the_last_metrics():
    calls = []

    def step(model, optimizer, tcfg, batch, priorities, iteration):
        calls.append((model, optimizer, tcfg, batch, priorities, iteration))
        return {"loss": torch.tensor(0.5 * iteration), "it": torch.tensor(iteration)}

    loop = mesh.make_parallel_train_loop(step, 3)
    got = loop("m", "o", "t", "batch", lambda i: f"p{i}", 4)
    assert calls == [("m", "o", "t", "batch", "p0", 4), ("m", "o", "t", "batch", "p1", 5),
                     ("m", "o", "t", "batch", "p2", 6)]
    assert set(got) == {"loss", "it"}
    assert torch.equal(got["loss"], torch.tensor(3.0)) and torch.equal(got["it"], torch.tensor(6))
    with pytest.raises(ValueError):
        mesh.make_parallel_train_loop(step, 0)


def _seeded_training(seed=0):
    from glass_tpu_torch.config import get_cfg
    from glass_tpu_torch.models import GlassArch, GlassRCNN
    from glass_tpu_torch.train.optimizer import build_optimizer
    from glass_tpu_torch.train.trainer import init_weights_
    from test_torch_train_step import ARCH_KW

    model = init_weights_(GlassRCNN(GlassArch(**ARCH_KW)), seed)
    return model, build_optimizer(get_cfg(), model)


def _torch_batch(batch):
    return {k: (v if k == "content_hw" else torch.from_numpy(v)) for k, v in batch.items()}


def _loop_tcfg():
    """tests/test_torch_train_step.py's training config with one word an
    image, for the bit-for-bit test: the recognizer's local CNN on 128x128
    crops is most of a step's CPU time, and equality does not depend on the
    word count."""
    from test_torch_train_step import TCFG_KW

    return dict(TCFG_KW, words_per_image=1)


def test_loop_equals_its_steps_bit_for_bit():
    """f32, the 64x64 two-image batch (``_loop_tcfg``): a loop of 3 against
    3 calls of the step from the same state, in parameters, buffers, the optimizer's state
    and the last step's metrics."""
    from glass_tpu_torch.train.train_step import Priorities, TrainConfig, train_step
    from test_torch_train_step import make_batch

    batch, tcfg = _torch_batch(make_batch()), TrainConfig(**_loop_tcfg())
    (m1, o1), (m2, o2) = _seeded_training(), _seeded_training()

    def priorities(i):
        return Priorities(3, 10 + i, "cpu")

    for i in range(3):
        want = train_step(m1, o1, tcfg, batch, priorities(i), 2 + i)
    got = mesh.make_parallel_train_loop(train_step, 3)(m2, o2, tcfg, batch, priorities, 2)
    assert _same(got, want)
    sd1, sd2 = m1.state_dict(), m2.state_dict()
    assert [k for k, v in sd1.items() if not torch.equal(v, sd2[k])] == []
    assert _same(o1.state_dict(), o2.state_dict())


def test_loop_matches_glass_tpus_loop():
    """``make_parallel_train_loop`` at n = 2 against glass_tpu's (one
    ``fori_loop`` program over its ``make_parallel_train_step`` on a
    one-device mesh, step i's key ``fold_in(key, i)``, then the shard's
    ``fold_in`` of the data index, as glass_tpu's Trainer folds it), from
    the same seeded weights on the same batch and config; the port's step i
    replays that key's draws (``JaxReplay``).  tests/test_torch_train_step.py's
    config at two words an image, held at that file's tolerances: the last
    step's losses and metrics, the BN statistics and the weights after two
    steps (the moved distance within the gradients' bound)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from glass_tpu.config import get_cfg as j_get_cfg
    from glass_tpu.models import GlassArch as JArch
    from glass_tpu.parallel import make_mesh
    from glass_tpu.parallel import make_parallel_train_step as j_make_parallel_train_step
    from glass_tpu.parallel import shard_batch as j_shard_batch
    from glass_tpu.parallel.mesh import make_parallel_train_loop as j_make_parallel_train_loop
    from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict
    from glass_tpu.train.optimizer import build_optimizer as j_build_optimizer
    from glass_tpu.train.train_step import TrainConfig as JTrainConfig
    from glass_tpu.train.train_step import glass_train_forward as j_forward
    from glass_tpu_torch.train.train_step import TrainConfig, train_step
    from glass_tpu_torch.weights import state_dict_from_jax_params
    from test_torch_train_step import ARCH_KW, GRAD_L2_TOL, TCFG_KW, JaxReplay, make_batch

    # two words an image, not that file's four: XLA:CPU runs the
    # convolutions of glass_tpu's loop body far slower than a dispatched
    # step's, and the recognizer's crops are most of a step; one word an
    # image leaves the recognizer's BN statistics too few rows for the bound
    batch, tcfg = make_batch(), dict(TCFG_KW, words_per_image=2)
    model, opt = _seeded_training()
    sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in sd0.items()}))
    jarch, jtcfg = JArch(**ARCH_KW), JTrainConfig(**tcfg, match_topk=16384)

    def loss_fn(p, b, key):  # glass_tpu's Trainer.loss_fn
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        total, losses, bn = j_forward(jarch, jtcfg, p, b, key, axis_name="data")
        return total, (losses, bn)

    mesh_ = make_mesh(jax.devices()[:1])
    tx, _ = j_build_optimizer(j_get_cfg(), params)
    j_step = j_make_parallel_train_step(mesh_, loss_fn, tx)
    key = jax.random.PRNGKey(5)
    j_params, _, j_metrics = j_make_parallel_train_loop(j_step, 2)(
        params, tx.init(params), j_shard_batch(mesh_, {k: jnp.asarray(v) for k, v in batch.items()}), key)
    j_sd = state_dict_from_jax_params(jax.device_get(j_params))

    def priorities(i):
        return JaxReplay(jax.random.fold_in(jax.random.fold_in(key, i), 0), 2)

    got = mesh.make_parallel_train_loop(train_step, 2)(model, opt, TrainConfig(**tcfg), _torch_batch(batch),
                                                        priorities)
    j_metrics = {k: float(v) for k, v in jax.device_get(j_metrics).items()}
    assert set(got) == set(j_metrics)
    # The mask head's pixel counts (accuracy, false positive and negative
    # shares) may move by one pixel: after the first update a mask logit
    # within rounding of zero can flip (measured: one pixel in 8624).  Every
    # fg roi takes a mask here (at most 32 * 0.25 = 8 an image, the masks'
    # cap), so one pixel is 1 / (28 * 28 * the batch's fg rois).
    assert tcfg["masks_per_image"] >= tcfg["roi_batch_per_image"] * 0.25
    pixel = 1.0 / (28 * 28 * 2 * j_metrics["roi_head/num_fg_samples"])
    bad = {k: (float(got[k]), want) for k, want in j_metrics.items()
           if not np.isclose(float(got[k]), want, rtol=1e-4,
                             atol=pixel + 1e-6 if k.startswith("mask_rcnn/") else 1e-6)}
    assert not bad, bad
    n_bn = 0
    for name, t in model.state_dict().items():
        want = j_sd[name].numpy()
        if "running_" in name:
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=name)
            n_bn += 1
            continue
        moved = np.linalg.norm(want - sd0[name].numpy())
        assert np.linalg.norm(t.numpy() - want) <= GRAD_L2_TOL * moved + 1e-6, name
    assert n_bn > 0
