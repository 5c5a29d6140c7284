"""The ResNet backward's cost per stage and per gradient kind: the
counterpart of ``tools/backbone_bwd_breakdown.py``.

For each stage of the port's ResNet-50 (stem, res2..res5) in training
mode (batch statistics), on a seeded bf16 input of the stage's shape at a
``--size`` image:

* ``fwd``: the stage's forward;
* ``fwd+dX``: ``torch.autograd.grad`` with respect to the input alone
  (the engine skips the weight gradients);
* ``fwd+dX+dW``: with respect to (parameters, input), the real backward;
* ``dW extra`` = (fwd+dX+dW) - (fwd+dX), ``bwd`` = (fwd+dX+dW) - fwd.

Each is timed over ``--k`` calls between two CUDA events after a warm-up,
best of ``--trials`` (the three interleaved, so that a drift of the
host's load reaches each alike).  The FLOPs (``FlopCounterMode``) and MFU
are of fwd+dX+dW, against the card's published bf16 peak.  The event
clock includes the host's dispatch, which can bound a stage alone at
batch 1 (PERF.md reads both on the H100); so each call is also timed on
the card alone (``*_device_ms``: ``common.graph_ms``, a
CUDA graph of the call replayed ``--k`` times), which splits dX from dW.
For ``WITNESS``, the stage's last 3x3 convolution alone
(``conv_witness``): ``F.conv2d`` on bf16 channels-last with the weight
cast once, and the port's conv layer, which casts its f32 weight each
call.

Usage: python -m glass_tpu_torch.tools.backbone_bwd_breakdown [--size 1024]
    [--trials 3] [--k 20] [--device cuda]
Prints a line a stage, then one JSON line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..inference.runner import random_init_
from ..models import layers as L
from ..models.resnet import RESNET50_STAGES, ResNet50
from . import common

DTYPE = "bfloat16"
WITNESS = "res4"


def stages(size: int, device):
    """[(name, module, input shape (1, C, H, W))] of the port's ResNet-50
    with seed-0 random weights, in training mode on ``device``."""
    net = random_init_(ResNet50(), 0).to(device).train()

    class Stem(torch.nn.Module):
        def __init__(self, conv1):
            super().__init__()
            self.conv1 = conv1

        def forward(self, x):
            return L.max_pool2d(self.conv1(x), 3, 2, 1)

    out = [("stem", Stem(net.stem.conv1), (1, 3, size, size))]
    hw, cin = size // 4, 64
    for name, _, _, cout, stride in RESNET50_STAGES:
        out.append((name, getattr(net, name), (1, cin, hw, hw)))
        hw, cin = hw // stride, cout
    return out


def _calls(module, x):
    params = [p for p in module.parameters() if p.requires_grad]

    def loss(xx):
        return module(xx).to(torch.float32).sum()

    def fwd():
        with torch.no_grad():
            return loss(x)

    def fwd_dx():
        return torch.autograd.grad(loss(x), [x])

    def fwd_dx_dw():
        return torch.autograd.grad(loss(x), [x, *params])

    def counted():
        """fwd+dX+dW's work through ``backward`` (``FlopCounterMode``'s
        module hooks refuse ``autograd.grad`` on leaves)."""
        loss(x).backward()
        for t in (x, *params):
            t.grad = None

    return fwd, fwd_dx, fwd_dx_dw, counted


def conv_witness(module, x, dev, k, trials) -> dict:
    """The stage's last 3x3 convolution (``module[-1].conv2``) alone on a
    seeded bf16 channels-last input of its shape: ``bare`` is ``F.conv2d``
    with the weight cast once, ``layer`` the port's ``layers.conv2d``
    (the f32 weight cast each call); event ms (best of ``trials``), the
    card's ms (``common.graph_ms``) and the MFU on it."""
    conv = module[-1].conv2
    with torch.no_grad():
        hw = module(x).shape[-2:]
    c = conv.weight.shape[1]
    xw = torch.from_numpy(np.random.RandomState(1).randn(1, c, *hw).astype(np.float32))
    xw = xw.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w16 = conv.weight.detach().to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def bare():
        return F.conv2d(xw, w16, None, 1, 1)

    def layer():
        return L.conv2d(xw, conv.weight, None, 1, 1)

    res = {"shape": [1, c, *hw], "weight": list(conv.weight.shape)}
    with torch.no_grad():
        res["gflops"] = common.count_flops(bare) / 1e9
        for n, fn in (("bare", bare), ("layer", layer)):
            res[f"{n}_ms"] = min(common.event_ms(fn, dev, k) for _ in range(trials))
            res[f"{n}_device_ms"] = common.graph_ms(fn, dev, k)
            res[f"{n}_device_mfu"] = (None if res[f"{n}_device_ms"] is None else
                                      common.mfu(res["gflops"] * 1e9, res[f"{n}_device_ms"], dev, DTYPE))
    return res


def run(size=1024, trials=3, k=20, device=None) -> dict:
    dev = common.setup(device)
    rows, witness = [], None
    for name, module, shape in stages(size, dev):
        x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        fwd, fwd_dx, fwd_dx_dw, counted = _calls(module, x)
        calls = (("fwd", fwd), ("fwd_dx", fwd_dx), ("fwd_dx_dw", fwd_dx_dw))
        t = {n: float("inf") for n, _ in calls}
        for _ in range(trials):
            for n, fn in calls:
                t[n] = min(t[n], common.event_ms(fn, dev, k))
        flops = common.count_flops(counted)
        mfu = common.mfu(flops, t["fwd_dx_dw"], dev, DTYPE)
        kern = {n: common.graph_ms(fn, dev, k) for n, fn in calls}
        row = {"stage": name, "fwd_ms": t["fwd"], "fwd_dx_ms": t["fwd_dx"], "fwd_dx_dw_ms": t["fwd_dx_dw"],
               "dw_extra_ms": t["fwd_dx_dw"] - t["fwd_dx"], "bwd_ms": t["fwd_dx_dw"] - t["fwd"],
               "full_gflops": flops / 1e9, "full_mfu": mfu,
               **{f"{n}_device_ms": v for n, v in kern.items()},
               "dw_extra_device_ms": None if kern["fwd"] is None else kern["fwd_dx_dw"] - kern["fwd_dx"],
               "full_device_mfu": None if kern["fwd"] is None else common.mfu(flops, kern["fwd_dx_dw"], dev, DTYPE)}
        rows.append(row)
        on_card = kern["fwd"] is not None
        print(f"{name:6s} fwd {row['fwd_ms']:7.3f}  +dX {row['fwd_dx_ms']:7.3f}  +dX+dW "
              f"{row['fwd_dx_dw_ms']:7.3f}  dW-extra {row['dw_extra_ms']:7.3f}  bwd {row['bwd_ms']:7.3f}  "
              f"MFU(full) {'-' if mfu is None else f'{100 * mfu:.2f}%'}"
              + (f"  on the card fwd {kern['fwd']:.3f} +dX {kern['fwd_dx']:.3f} +dX+dW {kern['fwd_dx_dw']:.3f}"
                 if on_card else ""), flush=True)
        if name == WITNESS:
            witness = dict(stage=name, **conv_witness(module, x, dev, k, trials))
            print(f"{name:6s} last 3x3 conv {witness['shape']}, {witness['gflops']:.2f} GFLOP: F.conv2d "
                  f"{witness['bare_ms']:.4f} ms on events, {witness['bare_device_ms']} on the card; port layer "
                  f"{witness['layer_ms']:.4f} / {witness['layer_device_ms']}", flush=True)
    return {"device": common.device_info(dev), "size": size, "k": k, "dtype": DTYPE, "stages": rows,
            "conv_witness": witness}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--k", type=int, default=20, help="timed calls a measurement, after a warm-up")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return common.emit(run(args.size, args.trials, args.k, args.device))


if __name__ == "__main__":
    main()
