"""SyncBN of the port against glass_tpu's, on the CPU.

Two gloo ranks run ``models.layers.batch_norm_train`` with the process group
on their own shard; glass_tpu runs ``layers.batch_norm(train=True,
axis_name="data")`` under ``shard_map`` on a 2-device mesh over the same two
shards, with a ``jax.vjp`` for the gradients.  The shards differ in content
(shifted and scaled), so a rank's own statistics are far from the synced
ones.  Compared per rank, f32, within 1e-5 of the largest magnitude: the
output, the running statistics (the unbiased variance with the shard's
element count, glass_tpu's quirk) and the input, weight and bias gradients
of <cotangent, output>.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glass_tpu.models.layers import batch_norm
from glass_tpu.parallel import make_mesh

from glass_tpu_torch.models.layers import batch_norm_train
from torch_dist_workers import load_ranks, run_ranks, syncbn_worker

torch.set_num_threads(2)
N, C, H, W = 2, 8, 5, 6
RTOL = 1e-5


def _shards(seed=0):
    rng = np.random.RandomState(seed)
    xs = np.stack([rng.randn(N, C, H, W), 3.0 + 2.5 * rng.randn(N, C, H, W)]).astype(np.float32)
    cots = rng.randn(2, N, C, H, W).astype(np.float32)
    params = dict(weight=1 + 0.1 * rng.randn(C), bias=0.1 * rng.randn(C),
                  running_mean=0.1 * rng.randn(C), running_var=0.5 + rng.rand(C))
    return xs, cots, {k: v.astype(np.float32) for k, v in params.items()}


def _glass_tpu(xs, cots, p):
    """Per shard: output, new running stats and the vjp, stacked by shard."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(jax.devices()[:2])

    def per_shard(x, cot, w, b):
        def f(x, w, b):
            return batch_norm(x, {"weight": w, "bias": b, "running_mean": p["running_mean"],
                                  "running_var": p["running_var"]}, train=True, axis_name="data")

        (out, new), vjp = jax.vjp(f, x, w, b)
        zero = jax.tree_util.tree_map(jnp.zeros_like, new)
        gx, gw, gb = vjp((cot, zero))
        return out, new["running_mean"][None], new["running_var"][None], gx, gw[None], gb[None]

    fn = jax.jit(shard_map(per_shard, mesh=mesh, in_specs=(P("data"), P("data"), P(), P()),
                           out_specs=P("data"), check_vma=False))
    nhwc = lambda a: np.transpose(a, (0, 1, 3, 4, 2)).reshape(2 * N, H, W, C)
    out, rm, rv, gx, gw, gb = jax.device_get(fn(nhwc(xs), nhwc(cots), p["weight"], p["bias"]))
    nchw = lambda a: np.transpose(a.reshape(2, N, H, W, C), (0, 1, 4, 2, 3))
    return dict(out=nchw(out), running_mean=rm, running_var=rv, gx=nchw(gx), gw=gw, gb=gb)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("syncbn")
    xs, cots, p = _shards()
    run_ranks(syncbn_worker, 2, (str(tmp), xs, p["weight"], p["bias"], p["running_mean"],
                                 p["running_var"], cots), tmp)
    return dict(port=load_ranks(str(tmp), 2), jax=_glass_tpu(xs, cots, p), xs=xs, cots=cots, p=p)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) <= RTOL * max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("what", ["out", "running_mean", "running_var", "gx", "gw", "gb"])
@pytest.mark.parametrize("r", [0, 1])
def test_syncbn_matches_glass_tpu(runs, what, r):
    assert _close(runs["port"][r][what].numpy(), runs["jax"][what][r]), (what, r)


def test_syncbn_differs_from_per_process_bn(runs):
    """The shards are far apart: each rank's own statistics would give
    another output (so the comparison above sees the sync)."""
    xs, p = runs["xs"], runs["p"]
    rm, rv = torch.from_numpy(p["running_mean"].copy()), torch.from_numpy(p["running_var"].copy())
    local = batch_norm_train(torch.from_numpy(xs[1]), torch.from_numpy(p["weight"]),
                             torch.from_numpy(p["bias"]), rm, rv)
    assert not _close(local.numpy(), runs["jax"]["out"][1])
    # the unbiased variance uses the shard's count n = N*H*W, not the group's
    n = N * H * W
    mean = xs.reshape(2, N, C, H * W).transpose(0, 2, 1, 3).reshape(2, C, -1).mean(axis=(0, 2))
    msq = (xs.astype(np.float64) ** 2).reshape(2, N, C, H * W).transpose(0, 2, 1, 3).reshape(2, C, -1)
    var = msq.mean(axis=(0, 2)) - mean.astype(np.float64) ** 2
    want = 0.9 * p["running_var"] + 0.1 * var * n / (n - 1)
    np.testing.assert_allclose(runs["port"][0]["running_var"].numpy(), want, rtol=1e-4)
