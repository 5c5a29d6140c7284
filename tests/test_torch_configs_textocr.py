"""configs/glass_finetune_textocr.yaml: the port against glass_tpu.

TextOCR's model differs from ICDAR15's: ``MODEL.ORIENTATION_ON`` is unset
(no orientation head, no orientation loss), its ``CHARACTER_SET`` is set
under ``ROI_MASK_HEAD`` (which the V3 recognizer does not read: both
packages keep the default 97-symbol vocabulary) and its recognizer's
``NORM`` is ``SyncBN`` (batch norm over one process here, as in
glass_tpu).  The checks and tolerances are tests/test_torch_configs_totaltext.py's.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_configs_totaltext import (  # noqa: E402
    FINETUNE_WORDS,
    ROOT,
    check_inference_single,
    check_runner_call,
    check_train_step,
    train_step,
)
from test_torch_train_step import make_batch  # noqa: E402

torch.set_num_threads(2)
CONFIG = os.path.join(ROOT, "configs", "glass_finetune_textocr.yaml")


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_inference_single_matches_glass_tpu(dtype):
    port, out = check_inference_single(CONFIG, dtype)
    assert not port.arch.orientation_on and port.arch.vocab_size == 97
    assert not hasattr(port.roi_heads.box_predictor, "orientation_pred")
    assert not out["orientations"].any()


def test_runner_call_matches_glass_tpu():
    check_runner_call(CONFIG)


def test_train_step_matches_glass_tpu():
    run = train_step(CONFIG, make_batch(), FINETUNE_WORDS)
    assert "loss_orientation" not in run["losses"]
    check_train_step(run)
