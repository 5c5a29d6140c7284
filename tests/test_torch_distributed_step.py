"""The port's data-parallel training step against glass_tpu's, on the CPU.

glass_tpu runs ``parallel.mesh.make_parallel_train_step`` on a 2-device
mesh (``shard_map``: each shard's loss with SyncBN and its key folded with
the shard index, then ``pmean`` of grads, total, losses and BN updates, then
SGD) over the two-image batch of tests/test_torch_train_step.py, from the
port's seeded training init carried across by glass_tpu's converter.  Its
transformation wraps glass_tpu's SGD and keeps the averaged gradients in the
optimizer state, so the one compiled step yields them too.

The port runs ``parallel.mesh.make_parallel_train_step`` on two gloo ranks,
rank r on row r of the batch, replaying glass_tpu's draws for shard r
(``JaxReplay`` of ``fold_in(key, r)``, recorded in the test process).
Compared at tests/test_torch_train_step.py's tolerances: every loss and
metric, every gradient, every BN update and the SGD step; both ranks'
parameters, statistics and gradients are bit-identical afterwards.  A
one-rank group gives the non-distributed step bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.models import GlassArch as JArch
from glass_tpu.parallel import make_mesh
from glass_tpu.parallel import make_parallel_train_step as j_make_parallel_train_step
from glass_tpu.parallel import shard_batch as j_shard_batch
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict
from glass_tpu.train.optimizer import build_optimizer as j_build_optimizer
from glass_tpu.train.train_step import TrainConfig as JTrainConfig
from glass_tpu.train.train_step import glass_train_forward as j_forward

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.parallel import shard_batch
from glass_tpu_torch.train.optimizer import build_optimizer
from glass_tpu_torch.train.train_step import Priorities, TrainConfig, glass_train_forward, train_step
from glass_tpu_torch.train.trainer import init_weights_
from glass_tpu_torch.weights import state_dict_from_jax_params
from test_torch_train_step import (
    ARCH_KW, GRAD_L2_TOL, HEAD_L2_TOL, HEADS, TCFG_KW, JaxReplay, _l2_err, make_batch,
)
from torch_dist_workers import Recorder, load_ranks, remove_large_files, run_ranks, step_worker, torch_batch

torch.set_num_threads(2)
KEY = 5


def capture_grads(tx):
    """``tx`` whose state also carries the gradients it was given."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def glass_tpu_step(sd0, batch):
    params = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in sd0.items()}))
    jarch, jtcfg = JArch(**ARCH_KW), JTrainConfig(**TCFG_KW, match_topk=16384)

    def loss_fn(p, b, key):  # glass_tpu's Trainer.loss_fn
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        total, losses, bn = j_forward(jarch, jtcfg, p, b, key, axis_name="data")
        return total, (losses, bn)

    mesh = make_mesh(jax.devices()[:2])
    tx, _ = j_build_optimizer(j_get_cfg(), params)
    tx = capture_grads(tx)
    step = j_make_parallel_train_step(mesh, loss_fn, tx)
    new, (_, grads), metrics = step(params, tx.init(params), j_shard_batch(mesh, batch),
                                    jax.random.PRNGKey(KEY))
    return dict(params=state_dict_from_jax_params(jax.device_get(new)),
                grads=state_dict_from_jax_params(jax.device_get(grads)),
                metrics={k: float(v) for k, v in metrics.items()})


def record_draws(model, shard, replay):
    """The draws the port's forward takes on ``shard`` (their shapes do not
    depend on the weights or the sync)."""
    rec = Recorder(replay)
    with torch.no_grad():
        glass_train_forward(model, TrainConfig(**TCFG_KW), torch_batch(shard), rec)
    return rec.draws


@pytest.fixture(scope="module")
def sd0():
    model = init_weights_(GlassRCNN(GlassArch(**ARCH_KW)), 0)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def run(sd0, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_step")
    batch = make_batch()
    sd_path = os.path.join(tmp, "sd0.pth")
    torch.save(sd0, sd_path)
    model = GlassRCNN(GlassArch(**ARCH_KW)).train()
    model.load_state_dict(sd0)
    shards = [shard_batch(batch, r, 2) for r in range(2)]
    draws = [record_draws(model, shards[r], JaxReplay(jax.random.fold_in(jax.random.PRNGKey(KEY), r), 1))
             for r in range(2)]
    del model
    run_ranks(step_worker, 2, (str(tmp), sd_path, shards, draws, ARCH_KW, TCFG_KW), tmp)
    ranks = load_ranks(str(tmp), 2)
    remove_large_files(tmp)
    return dict(ranks=ranks, jax=glass_tpu_step(sd0, batch), sd0=sd0)


def test_losses_and_metrics_match(run):
    got, want = run["ranks"][0]["metrics"], run["jax"]["metrics"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert got["rpn/num_pos_anchors"] > 0 and got["roi_head/num_fg_samples"] > 0


def test_every_gradient_matches(run):
    grads, want = run["ranks"][0]["grads"], run["jax"]["grads"]
    assert set(grads) == {k for k in want if "running_" not in k}
    bad = {}
    for name, g in grads.items():
        g, w = g.numpy(), want[name].numpy()
        if np.abs(w).max() < 1e-6:  # rounding noise
            ok = np.abs(g - w).max() <= 1e-6
        else:
            ok = _l2_err(g, w) <= (HEAD_L2_TOL if name.startswith(HEADS) else GRAD_L2_TOL)
        if not ok:
            bad[name] = _l2_err(g, w)
    assert not bad, bad


def test_bn_updates_match(run):
    state, want = run["ranks"][0]["state"], run["jax"]["params"]
    names = [k for k in state if "running_" in k]
    assert names and set(names) == {k for k in want if "running_" in k}
    for k in names:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_one_sgd_step_matches(run):
    state, want, sd0 = run["ranks"][0]["state"], run["jax"]["params"], run["sd0"]
    for name in run["ranks"][0]["grads"]:
        step = want[name].numpy() - sd0[name].numpy()
        err = np.linalg.norm(state[name].numpy() - want[name].numpy())
        assert err <= GRAD_L2_TOL * np.linalg.norm(step) + 1e-6, name


def test_replicas_bit_identical(run):
    assert all(r["agree"] for r in run["ranks"])
    assert run["ranks"][0]["metrics"] == run["ranks"][1]["metrics"]


def test_one_rank_group_is_the_plain_step(sd0, tmp_path):
    """``make_parallel_train_step`` in a one-rank group (its all-reduce
    over one rank, BN unsynced) against ``train_step`` with no group."""
    batch = make_batch()
    model = GlassRCNN(GlassArch(**ARCH_KW)).train()
    model.load_state_dict(sd0)
    rec = Recorder(Priorities(3, 0, "cpu"))
    metrics = train_step(model, build_optimizer(get_cfg(), model), TrainConfig(**TCFG_KW),
                         torch_batch(batch), rec, 0)
    sd_path = os.path.join(tmp_path, "sd0.pth")
    torch.save(sd0, sd_path)
    run_ranks(step_worker, 1, (str(tmp_path), sd_path, [batch], [rec.draws], ARCH_KW, TCFG_KW), tmp_path)
    (got,) = load_ranks(str(tmp_path), 1)
    remove_large_files(tmp_path)
    assert got["metrics"] == {k: float(v) for k, v in metrics.items()}
    for k, v in model.state_dict().items():
        assert torch.equal(got["state"][k], v), k
    for n, p in model.named_parameters():
        assert torch.equal(got["grads"][n], p.grad), n
