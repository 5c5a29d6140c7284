"""Seeded weights, made by the benchmark on the device: one state dict
with detectron2's names, which the program loads and the reference loads.

The parameters come from a ``torch.Generator`` on the device in three large
calls (every matrix and kernel from one normal draw, the batch-norm scales
and running means from a second, the running variances from one uniform
draw), scaled leaf by leaf: N(0, 2/fan_in) weights, zero biases, unit
LayerNorm scales, batch-norm scales 1 + 0.1 N(0, 1), running means
0.1 N(0, 1), running variances 0.5 + U(0, 1), and the last batch norm of
every residual branch scaled by 1/4, so that a deep random network keeps
its activations of order one.

* ``serve``: the running statistics are then set to those of the
  reference's own activations on one scene (``calibrate``), so that a
  random model's scores, boxes and words vary as a trained model's do.
* ``train``: detectron2's small init of the predictors (RPN and class and
  orientation scores 0.01, box and mask deltas 0.001, zero biases), zero
  offsets of every deformable convolution (its ``conv2_offset``: the
  deformable trunk starts as the plain one) and identity running
  statistics, as a training run starts.
"""

from __future__ import annotations

import math

import torch

from ..reference.glass.models.context import BatchNorm2d
from ..reference.glass.models.local_extractor import BasicBlock
from ..reference.glass.models.resnet import BottleneckBlock
from ..reference.runner import GlassArch, GlassRCNN, f32_cfg

SMALL_PREDICTORS = (
    ("proposal_generator.rpn_head.conv", 0.01),
    ("proposal_generator.rpn_head.objectness_logits", 0.01),
    ("proposal_generator.rpn_head.anchor_deltas", 0.01),
    ("roi_heads.box_predictor.cls_score", 0.01),
    ("roi_heads.box_predictor.bbox_pred", 0.001),
    ("roi_heads.box_predictor.orientation_pred", 0.01),
    ("roi_heads.mask_head.predictor", 0.001),
)


def _layout(cfg):
    """The model's modules and state-dict entries, built on the meta
    device (no memory, no arithmetic)."""
    with torch.device("meta"):
        model = GlassRCNN(GlassArch.from_config(f32_cfg(cfg)))
    return model


def seeded_state_dict(cfg, seed: int, device, kind: str) -> dict:
    """The ``kind`` ("serve" or "train") weights of ``cfg``'s model from
    ``seed``, as f32 tensors on ``device``."""
    model = _layout(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    params = dict(model.named_parameters())
    bns = {name: m for name, m in model.named_modules() if isinstance(m, BatchNorm2d)}
    norms = {name for name, m in model.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    quarter = {f"{n}.conv3.norm" for n, m in model.named_modules() if isinstance(m, BottleneckBlock)}
    quarter |= {f"{n}.bn2" for n, m in model.named_modules() if isinstance(m, BasicBlock)}

    mats = [n for n, p in params.items() if p.dim() >= 2]
    flat = torch.randn(sum(params[n].numel() for n in mats), generator=gen, device=device)
    n_bn = sum(m.weight.numel() for m in bns.values())
    bn_normal = torch.randn(2 * n_bn, generator=gen, device=device)
    bn_uniform = torch.rand(n_bn, generator=gen, device=device)

    out, off = {}, 0
    for n in mats:
        p = params[n]
        fan_in = 1 if "tgt_embedding" in n else p[0].numel()
        out[n] = flat[off: off + p.numel()].view(p.shape) * math.sqrt(2.0 / fan_in)
        off += p.numel()
    for n, p in params.items():
        if n in out:
            continue
        module = n.rsplit(".", 1)[0]
        out[n] = (torch.ones if module in norms and n.endswith(".weight") else torch.zeros)(
            p.shape, device=device)
    off = 0
    for name, m in bns.items():
        c = m.weight.numel()
        scale = 0.25 if name in quarter else 1.0
        out[f"{name}.weight"] = (1.0 + 0.1 * bn_normal[off: off + c]) * scale
        out[f"{name}.running_mean"] = 0.1 * bn_normal[n_bn + off: n_bn + off + c]
        out[f"{name}.running_var"] = 0.5 + bn_uniform[off: off + c]
        off += c
    if kind == "train":
        small = torch.Generator(device=device).manual_seed((int(seed) + 1) % (2 ** 63))
        for prefix, std in SMALL_PREDICTORS:
            if f"{prefix}.weight" in out:
                w = out[f"{prefix}.weight"]
                out[f"{prefix}.weight"] = torch.randn(w.shape, generator=small, device=device) * std
                out[f"{prefix}.bias"] = torch.zeros_like(out[f"{prefix}.bias"])
        for n in params:
            if ".conv2_offset." in n:
                out[n] = torch.zeros_like(out[n])
        for name in bns:
            out[f"{name}.running_mean"] = torch.zeros_like(out[f"{name}.running_mean"])
            out[f"{name}.running_var"] = torch.ones_like(out[f"{name}.running_var"])
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise KeyError(f"no seeded value for {sorted(missing)[:5]}")
    return {k: out[k].contiguous() for k in model.state_dict()}


def calibrate(ref_runner, image) -> dict:
    """Set every batch norm's running statistics of the reference model to
    those of its input on ``image`` (one eval-path forward at float32);
    returns the model's state dict."""
    model = ref_runner.model

    def hook(bn, args):
        x = args[0].to(torch.float32)
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm2d)]
    try:
        resized, _ = ref_runner.eval_resize(image)
        ref_runner.run_model(resized)
    finally:
        for h in handles:
            h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
