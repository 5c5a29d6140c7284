"""The program's names that the benchmark's harness patches, wraps or calls
by a private name (``benchmark/harness/{capture,loops,roofline}.py``):
each must exist and be callable, so that a rename or a fusion fails here
instead of turning the benchmark's ``correct`` false or emptying a
per-layer metric."""

import importlib
import os

import pytest
import torch

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner

torch.set_num_threads(2)
ICDAR15 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                       "glass_finetune_icdar15.yaml")
SMALL = ["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96", "TPU.IMAGE_BUCKETS", "[[64, 96]]",
         "TPU.COMPUTE_DTYPE", "float32"]

# (where, name): a module's global, a GlassRunner class attribute, or an
# attribute of a built runner (``runner``) or of its model's box head
SEAMS = [
    ("glass_tpu_torch.inference.runner", "glass_inference_single"),    # capture.Capture
    ("glass_tpu_torch.models.glass_rcnn", "backbone_features"),        # capture.Capture
    ("glass_tpu_torch.models.rpn", "select_proposals_batch"),          # capture.Capture
    ("runner.model.roi_heads", "box_predictor"),                       # capture.Capture's hook
    ("glass_tpu_torch.train.train_step", "select_proposals_single_image"),  # capture.StepRecorder
    ("glass_tpu_torch.ops.roi_align_rotated", "_pool_forward"),        # roofline.Launches
    ("glass_tpu_torch.ops.roi_align_rotated", "roi_align_rotated_packed_backward"),  # roofline.Launches
    ("glass_tpu_torch.ops.crop", "crop_rois_batched"),                 # roofline.Launches
    ("glass_tpu_torch.models.glass_rcnn", "crop_rois_batched"),        # roofline.Launches
    ("GlassRunner", "_model_postprocess"),                             # loops.HostSpans
    ("runner", "post_processor"),                                      # loops.HostSpans
    ("GlassRunner", "batch_model_fn"),                                 # loops._probe_batch_model
    ("GlassRunner", "_pick_bucket"),                                   # loops' model probes
]


@pytest.fixture(scope="module")
def runner():
    return GlassRunner(cfg=get_cfg(ICDAR15, SMALL), device="cpu")


@pytest.mark.parametrize("where,name", SEAMS, ids=[f"{w}.{n}" for w, n in SEAMS])
def test_the_harness_seam_exists_and_is_callable(request, where, name):
    if where == "GlassRunner":
        owner = GlassRunner
    elif where.startswith("runner"):
        owner = request.getfixturevalue("runner")
        for part in where.split(".")[1:]:
            owner = getattr(owner, part)
    else:
        owner = importlib.import_module(where)
    assert callable(getattr(owner, name, None)), f"{where}.{name}"
