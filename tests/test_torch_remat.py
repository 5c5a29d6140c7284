"""``TPU.REMAT_BACKBONE`` in the port, on the CPU.

The port checkpoints the backbone (``train_step.remat_backbone_features``:
``torch.utils.checkpoint`` without reentry) where glass_tpu runs
``jax.checkpoint`` over it.  Rematerialization changes where activations
live, not what is computed, so on the CPU the port's remat step equals its
plain step bit for bit: every loss, every gradient and the BN running
statistics after the step.  The statistics are the check that matters:
the recomputation runs the backbone's forward again, and a batch norm that
updated its running statistics there would apply the EMA twice a step,
which losses and gradients do not show.

The remat step is also held to glass_tpu's remat step (``glass_train_
forward`` with ``remat_backbone=True``, its draws replayed) at the
tolerances of tests/test_torch_train_step.py, which states their reasons.

Under SyncBN the recomputation issues the statistics' all-reduces again:
two gloo ranks run a two-layer conv + SyncBN backbone plain and
checkpointed, and each rank's output, gradients and statistics are equal
bit for bit while the checkpointed run issues one more all-reduce per BN
layer.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from glass_tpu.models import GlassArch as JArch  # noqa: E402
from glass_tpu.train.checkpoint import _walk_rename, convert_torch_state_dict  # noqa: E402
from glass_tpu.train.train_step import TrainConfig as JTrainConfig  # noqa: E402
from glass_tpu.train.train_step import glass_train_forward as j_forward  # noqa: E402

from glass_tpu_torch.models import GlassArch, GlassRCNN  # noqa: E402
from glass_tpu_torch.train.train_step import TrainConfig, glass_train_forward  # noqa: E402
from glass_tpu_torch.train.trainer import init_weights_  # noqa: E402
from glass_tpu_torch.weights import state_dict_from_jax_params  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    ARCH_KW,
    GRAD_L2_TOL,
    HEAD_L2_TOL,
    HEADS,
    TCFG_KW,
    JaxReplay,
    make_batch,
)
from torch_dist_workers import load_ranks, run_ranks, syncbn_remat_worker  # noqa: E402

torch.set_num_threads(2)


def _port_step(remat, batch, key):
    model = init_weights_(GlassRCNN(GlassArch(**ARCH_KW, remat_backbone=remat)), 0).train()
    tb = {k: (v if k == "content_hw" else torch.from_numpy(v)) for k, v in batch.items()}
    total, losses = glass_train_forward(model, TrainConfig(**TCFG_KW), tb, JaxReplay(key, 2))
    total.backward()
    return dict(
        total=total.detach(), losses={k: v.detach() for k, v in losses.items()},
        grads={n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
        bn={k: v.clone() for k, v in model.state_dict().items() if "running_" in k},
    )


@pytest.fixture(scope="module")
def run():
    batch = make_batch()
    key = jax.random.PRNGKey(5)
    plain, remat = _port_step(False, batch, key), _port_step(True, batch, key)
    sd0 = init_weights_(GlassRCNN(GlassArch(**ARCH_KW)), 0).state_dict()
    params = _walk_rename(convert_torch_state_dict({k: v.numpy() for k, v in sd0.items()}))
    jarch = JArch(**ARCH_KW, remat_backbone=True)
    jtcfg = JTrainConfig(**TCFG_KW, match_topk=16384)

    def loss_fn(p):
        total, losses, bn = j_forward(jarch, jtcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        return total, (losses, bn)

    (j_total, (j_losses, j_bn)), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return dict(plain=plain, remat=remat, j_total=float(j_total),
                j_losses={k: float(v) for k, v in j_losses.items()},
                j_grads=state_dict_from_jax_params(jax.device_get(j_grads)), j_bn=jax.device_get(j_bn))


@pytest.mark.parametrize("what", ["losses", "grads", "bn"])
def test_remat_step_equals_the_plain_step_bit_for_bit(run, what):
    plain, remat = run["plain"][what], run["remat"][what]
    assert set(plain) == set(remat) and plain
    differ = [k for k in plain if not torch.equal(plain[k], remat[k])]
    assert not differ, differ
    if what == "losses":
        assert torch.equal(run["plain"]["total"], run["remat"]["total"])


def _l2_err(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_remat_step_matches_glass_tpu_remat(run):
    """Losses 1e-4 relative, gradients per tensor 1e-3 (heads) / 5e-2 in
    relative L2 (1e-6 abs where the gradient is rounding noise), BN updates
    1e-4 relative: tests/test_torch_train_step.py's bounds."""
    got = run["remat"]
    assert set(got["losses"]) == set(run["j_losses"])
    for k, want in run["j_losses"].items():
        np.testing.assert_allclose(float(got["losses"][k]), want, rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(got["total"]), run["j_total"], rtol=1e-4)
    bad = {}
    for name, g in got["grads"].items():
        g, want = g.numpy(), run["j_grads"][name].numpy()
        if np.abs(want).max() < 1e-6:
            ok = np.abs(g - want).max() <= 1e-6
        else:
            ok = _l2_err(g, want) <= (HEAD_L2_TOL if name.startswith(HEADS) else GRAD_L2_TOL)
        if not ok:
            bad[name] = _l2_err(g, want)
    assert not bad, bad
    n = 0
    for path, stats in run["j_bn"].items():
        for stat in ("running_mean", "running_var"):
            np.testing.assert_allclose(got["bn"][f"{path}.{stat}"].numpy(), np.asarray(stats[stat]),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{path}.{stat}")
            n += 1
    assert n == len(got["bn"])


def test_syncbn_remat_reissues_its_all_reduces_and_equals_plain(tmp_path):
    rng = np.random.RandomState(0)
    # the two ranks' images differ in level and spread, so synced and
    # per-rank statistics differ
    image = np.stack([rng.randn(2, 12, 16, 3), 2.0 + 3.0 * rng.randn(2, 12, 16, 3)]).astype(np.float32)
    cot = rng.randn(2, 2, 8, 6, 8).astype(np.float32)
    run_ranks(syncbn_remat_worker, 2, (str(tmp_path), image, cot), tmp_path)
    for r, res in enumerate(load_ranks(str(tmp_path), 2)):
        plain, remat = res["plain"], res["remat"]
        assert torch.equal(plain["out"], remat["out"]), r
        for part in ("grads", "stats"):
            assert set(plain[part]) == set(remat[part])
            assert all(torch.equal(v, remat[part][k]) for k, v in plain[part].items()), (r, part)
        # forward and backward a BN layer each (2 layers), and the
        # recomputation's forward again
        assert (plain["all_reduces"], remat["all_reduces"]) == (4, 6), r
