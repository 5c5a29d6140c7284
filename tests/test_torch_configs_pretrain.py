"""configs/glass_pretrain.yaml: the port against glass_tpu, from a caffe2 trunk.

Pretraining starts from a caffe2 ImageNet R-50 ``.pkl``
(``MODEL.WEIGHTS``; here a synthetic one built in the test, He-scaled so a
random trunk keeps its activations of order one), runs its recognizer at
``MAX_BATCH_SIZE`` 1 (one word an image) and ``IMS_PER_BATCH`` 8.  Each
package loads the ``.pkl`` by its own reader onto the other weights'
initialisation; then the checks of tests/test_torch_configs_totaltext.py
with its tolerances: inference and ``__call__`` (the trunk loaded, the
rest random, BN calibrated), and one training step.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from glass_tpu.train.checkpoint import load_torch_checkpoint as j_load_torch_checkpoint
from glass_tpu.train.checkpoint import overlay_params

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.train.checkpoint import load_weights_
from glass_tpu_torch.train.trainer import init_weights_

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_checkpoint_formats import caffe2_trunk  # noqa: E402
from test_torch_configs_totaltext import (  # noqa: E402
    ROOT,
    TRAIN_OPTS,
    check_inference_single,
    check_runner_call,
    check_train_step,
    to_params,
    train_step,
)
from test_torch_train_step import make_batch  # noqa: E402

torch.set_num_threads(2)
CONFIG = os.path.join(ROOT, "configs", "glass_pretrain.yaml")


@pytest.fixture(scope="module")
def trunk_pkl(tmp_path_factory):
    """A caffe2 trunk drawn as ``random_init_`` draws a model: He-scaled
    convolutions, BN scales near 1 (a quarter of that on the last BN of
    each residual branch), small biases."""
    state = caffe2_trunk(seed=3)
    for k, v in state.items():
        if k.endswith("_w"):
            state[k] = (v * np.sqrt(2.0 / v[0].size)).astype(np.float32)
        elif k.endswith("_bn_s"):
            scale = 0.25 if "_branch2c_" in k else 1.0
            state[k] = (scale * (1.0 + 0.1 * v)).astype(np.float32)
        else:
            state[k] = (0.1 * v).astype(np.float32)
    path = str(tmp_path_factory.mktemp("pretrain") / "R-50.pkl")
    with open(path, "wb") as f:
        pickle.dump(state, f)
    return path


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_inference_single_matches_glass_tpu(trunk_pkl, dtype):
    port, _ = check_inference_single(CONFIG, dtype, load=lambda m: load_weights_(m, trunk_pkl))
    assert port.arch.orientation_on


def test_runner_call_matches_glass_tpu(trunk_pkl):
    check_runner_call(CONFIG, load=lambda m: load_weights_(m, trunk_pkl))


def test_train_step_from_the_trunk_matches_glass_tpu(trunk_pkl):
    """tests/test_torch_train_step.py's batch of two images, one word an
    image; glass_tpu overlays the ``.pkl`` by ``load_torch_checkpoint`` +
    ``overlay_params``, the port by its training loader (``--weights``).
    Not the config's 8 images: on four of these batches a 1e-7 relative
    perturbation of the weights moves the port's own RPN conv gradient by
    7.4e-3 in relative L2 (a ReLU or a sampled anchor switching), so the
    heads' 1e-3 bound would sit below that tensor's conditioning;
    chip_smoke.py's phase 9 runs the config at IMS_PER_BATCH 8."""
    cfg = get_cfg(CONFIG, TRAIN_OPTS)
    assert cfg.SOLVER.IMS_PER_BATCH == 8 and cfg.MODEL.ROI_RECOGNIZER_HEAD.MAX_BATCH_SIZE == 1
    init = init_weights_(GlassRCNN(GlassArch.from_config(cfg)), 0)
    params = overlay_params(to_params(init.state_dict()), j_load_torch_checkpoint(trunk_pkl))
    model = load_weights_(init, trunk_pkl)
    with open(trunk_pkl, "rb") as f:
        trunk = pickle.load(f)
    np.testing.assert_array_equal(model.state_dict()["backbone.bottom_up.res4.5.conv3.weight"].numpy(),
                                  trunk["res4_5_branch2c_w"])
    run = train_step(CONFIG, make_batch(), model=model, params=params)
    assert run["tcfg"].words_per_image == 1
    check_train_step(run)
