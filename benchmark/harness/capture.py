"""What the timed path produced, kept for the images the run compares.

``Capture`` wraps four seams of a served model program: the runner
module's ``glass_inference_single`` (every image the timed path runs goes
through it, in order, on one thread at a time), ``backbone_features`` (the
FPN levels), the RPN's ``select_proposals_batch`` (its inputs, the head's
masked objectness logits and deltas, and the proposals it returns) and the
box predictor's forward (class logits, box deltas, orientation logits).
For an image whose sequence number is in ``wanted`` it copies each to the
host as it is produced; any other image passes through untouched.  On the
card the copies go on a side stream into pinned host buffers reserved in
set-up (``reserve``), after the work that produced them and without
blocking the host or the program's stream, so that a compared image costs
the timed path no more than a few launches.  The same class wraps the
reference's copy when the control takes the program's place.

``StepRecorder`` does the same for training: the proposal selection of each
step (inputs and outputs), so that the reference can follow the program's
steps and judge the selection on its own.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten


def host(t):
    if torch.is_tensor(t):
        return t.detach().to("cpu", copy=True)
    if isinstance(t, (list, tuple)):
        return type(t)(host(v) for v in t)
    if isinstance(t, dict):
        return {k: host(v) for k, v in t.items()}
    return t


class Capture:
    def __init__(self, runner_module, glass_rcnn_module, rpn_module, model, wanted=()):
        self.mods = (runner_module, glass_rcnn_module, rpn_module)
        self.model = model
        self.wanted = set(wanted)
        self.seq, self.current, self.kept = 0, None, {}
        self._orig = None
        self.stream, self.slots = None, []

    def _keep(self, key, value):
        """``self.current[key] = value`` on the host: at once on the CPU, on
        the side stream into the current slot's pinned buffers on the card
        (a synchronous copy when no slot was reserved)."""
        leaves, spec = tree_flatten(value)
        tensors = [t for t in leaves if torch.is_tensor(t)]
        if self.stream is None or not tensors or not tensors[0].is_cuda:
            self.current[key] = host(value)
            return
        if "_slot" not in self.current:
            self.current["_slot"] = self.slots.pop() if self.slots else {}
        bufs = self.current["_slot"].get(key)
        if bufs is None or [tuple(b.shape) for b in bufs] != [tuple(t.shape) for t in tensors]:
            bufs = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, pin_memory=True) for t in tensors]
        self.stream.wait_stream(torch.cuda.current_stream(tensors[0].device))
        with torch.cuda.stream(self.stream):
            for b, t in zip(bufs, tensors):
                b.copy_(t.detach(), non_blocking=True)
                t.record_stream(self.stream)
        it = iter(bufs)
        self.current[key] = tree_unflatten([next(it) if torch.is_tensor(v) else v for v in leaves], spec)

    def reserve(self, n: int):
        """Pinned buffers for ``n`` compared images, shaped as the first
        image this capture kept (a warm-up image)."""
        if not self.kept or not torch.cuda.is_available():
            return
        first = next(iter(self.kept.values()))
        self.stream = self.stream or torch.cuda.Stream()
        self.slots = []
        for _ in range(n):
            slot = {}
            for key, value in first.items():
                if key == "_slot":
                    continue
                leaves, _ = tree_flatten(value)
                slot[key] = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, pin_memory=True)
                             for t in leaves if torch.is_tensor(t)]
            self.slots.append(slot)

    def finish(self):
        """Wait for the side stream's copies; drop the slot records."""
        if self.stream is not None:
            self.stream.synchronize()
        for kept in self.kept.values():
            kept.pop("_slot", None)

    def _single(self, model, image, hw):
        idx = self.seq
        self.seq += 1
        if idx not in self.wanted:
            return self._orig[0](model, image, hw)
        self.current = self.kept.setdefault(idx, {})
        try:
            out = self._orig[0](model, image, hw)
            self._keep("out", out)
        finally:
            self.current = None
        return out

    def _backbone(self, model, norm):
        feats = self._orig[1](model, norm)
        if self.current is not None:
            self._keep("feats", feats)
        return feats

    def _select(self, logits, deltas, anchors, image_sizes, *args, **kw):
        out = self._orig[2](logits, deltas, anchors, image_sizes, *args, **kw)
        if self.current is not None:
            self._keep("select_in", (logits, deltas, image_sizes))
            self._keep("select_out", out)
        return out

    def _predictor(self, module, args, out):
        if self.current is not None:
            self._keep("predictor", out)

    def install(self):
        runner, rcnn, rpn = self.mods
        self._orig = (runner.glass_inference_single, rcnn.backbone_features, rpn.select_proposals_batch)
        runner.glass_inference_single = self._single
        rcnn.backbone_features = self._backbone
        rpn.select_proposals_batch = self._select
        self._hook = self.model.roi_heads.box_predictor.register_forward_hook(self._predictor)
        return self

    def remove(self):
        runner, rcnn, rpn = self.mods
        runner.glass_inference_single, rcnn.backbone_features, rpn.select_proposals_batch = self._orig
        self._hook.remove()

    def restart(self, wanted):
        """Count images from 0 again (the window starts) and keep ``wanted``."""
        self.seq, self.wanted, self.kept = 0, set(wanted), {}


class StepRecorder:
    """Records every call of a training step's proposal selection
    (``train_step.select_proposals_single_image``) while ``on``."""

    def __init__(self, train_step_module):
        self.mod, self.on, self.calls = train_step_module, True, []

    def _select(self, logits, deltas, anchors, content_hw, *args):
        out = self.fn(logits, deltas, anchors, content_hw, *args)
        if self.on:
            self.calls.append({"in": host((logits, deltas, content_hw, args)), "out": host(out)})
        return out

    def install(self):
        self.fn = self.mod.select_proposals_single_image
        self.mod.select_proposals_single_image = self._select
        return self

    def remove(self):
        self.mod.select_proposals_single_image = self.fn
