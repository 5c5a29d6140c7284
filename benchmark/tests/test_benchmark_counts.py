"""The yardstick's counts against hand-worked shapes: each kernel's bytes
and operations, and the reference's FLOPs."""

import numpy as np
import torch

from benchmark.harness import roofline
from benchmark.kernels import k1, k1b, k2
from benchmark.reference.glass.models import glass_rcnn as R
from benchmark.reference.glass.models.glass_rcnn import GlassArch, GlassRCNN

# one 8x8 level of 4 channels; one axis-aligned 2x2 roi centred at (4, 4):
# its one sample, at (3.5, 3.5) after the half-pixel shift, taps rows
# (3, 3), (3, 4), (4, 3), (4, 4)
META = torch.tensor([[1.0, 8.0, 8.0, 0.0]])
ROIS = torch.tensor([[4.0, 4.0, 2.0, 2.0, 0.0]])
LEVELS = torch.zeros(1, dtype=torch.int32)
GRID = torch.ones((1, 2), dtype=torch.int32)


def test_touched_rows_of_one_sample():
    assert roofline.touched_rows(META, ROIS, LEVELS, GRID, (1, 1)) == 4


def test_k1_cost():
    call = {"meta": META, "rois": ROIS, "levels": LEVELS, "grid": GRID, "out_hw": (1, 1),
            "channels": 4, "elt": 4}
    # output 1x1x4 f32 written (16 B), four rows of 4 f32 read (64 B); 8 operations a channel a sample
    assert k1.cost(call) == (16 + 64, 8 * 4)


def test_k1_cost_counts_a_row_shared_by_two_rois_once():
    call = {"meta": META, "rois": ROIS.repeat(2, 1), "levels": LEVELS.repeat(2), "grid": GRID.repeat(2, 1),
            "out_hw": (1, 1), "channels": 4, "elt": 2}
    assert k1.cost(call) == (2 * 4 * 2 + 4 * 4 * 2, 2 * 8 * 4)


def test_k1b_cost():
    call = {"rois": ROIS, "grid": torch.full((1, 2), 2, dtype=torch.int32), "out_hw": (1, 1), "channels": 4,
            "elt": 2, "n_rows": 64, "out_elt": 2}
    # upstream gradient 1x1x4 bf16 read, the dense 64x4 bf16 gradient written; 2x2 samples
    assert k1b.cost(call) == (8 + 64 * 4 * 2, 8 * 4 * 4)


def test_k2_cost():
    call = {"images_shape": (1, 8, 8, 3), "image_elt": 1, "rois": ROIS[None], "out_hw": (1, 1),
            "sampling_ratio": 1, "max_sampling_ratio": 2, "out_elt": 4}
    # one f32 pixel of 3 channels written, four uint8 pixels of 3 channels read
    assert k2.cost(call) == (12 + 4 * 3, 8 * 3)


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s((3.35e12, 0)) == 1.0
    assert roofline.least_s((0, 67e12)) == 1.0
    assert roofline.least_s((3.35e12, 2 * 67e12)) == 2.0


def test_reference_flops_of_the_backbone_are_twice_its_macs():
    from torch.utils.flop_counter import FlopCounterMode

    model = GlassRCNN(GlassArch(compute_dtype="float32")).eval()
    norm = torch.from_numpy(np.random.RandomState(0).randn(64, 64, 3).astype(np.float32))
    macs = []

    def hook(mod, inputs, out):
        cin, kh, kw = mod.weight.shape[1:]
        macs.append(out.numel() * cin * kh * kw)

    handles = [m.register_forward_hook(hook) for m in model.backbone.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        with FlopCounterMode(display=False) as counter:
            R.backbone_features(model, norm)
    for h in handles:
        h.remove()
    assert len(macs) == 53 + 8  # ResNet-50 (stem, 16 blocks of 3, 4 shortcuts) + FPN (4 lateral, 4 output)
    assert counter.get_total_flops() == 2 * sum(macs) > 0


def test_a_share_is_none_without_calls_or_time():
    class Trace:
        def kernels(self, match):
            return []

    assert roofline.share([], "k1", Trace()) is None
