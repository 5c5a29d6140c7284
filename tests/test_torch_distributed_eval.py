"""Multi-process evaluation and data-parallel serving of the port, on the CPU.

``python -m glass_tpu_torch.eval`` on two gloo ranks (each evaluates
``records[rank::2]``, the evaluator gathers) gives the ``results.json`` and
the det zip of one process over the images, model and opts of
tests/test_torch_eval_cli.py; rank 0 alone writes them.

``TPU.SERVE_DATA_PARALLEL`` over two CPU replicas (the rows of a batch split
over them, the batch padded with a zero image to a multiple of two) equals
b = 1 serving bit for bit at b = 3 and b = 4, on the model and images of
tests/test_torch_batch_eval.py; with one device it is the one-replica path.
"""

import json
import os

import numpy as np
import pytest
import torch

from glass_tpu_torch import eval as port_eval
from glass_tpu_torch.inference import GlassRunner
from test_torch_batch_eval import _assert_same, _runner, images
from test_torch_batch_eval import model  # noqa: F401  (the fixture)
from test_torch_eval_cli import ICDAR15, OPTS, make_dataset, read_zip, save_random_model
from torch_dist_workers import eval_worker, load_ranks, remove_large_files, run_ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_eval"))
    ds_yaml, image = make_dataset(tmp, n_images=5)
    pth = os.path.join(tmp, "model.pth")
    save_random_model(pth, image)
    argv = ["--config", ICDAR15, "--datasets", ds_yaml, "--model", pth, "--device", "cpu", *OPTS]
    single = port_eval.main(["--output", os.path.join(tmp, "single")] + argv)
    run_ranks(eval_worker, 2, (tmp, argv), tmp)
    ranks = load_ranks(tmp, 2)
    remove_large_files(tmp)
    return dict(tmp=tmp, single=single, ranks=ranks)


def test_two_ranks_give_the_results_of_one_process(runs):
    tmp = runs["tmp"]
    with open(os.path.join(tmp, "single", "results.json")) as f:
        want = json.load(f)
    with open(os.path.join(tmp, "r0", "results.json")) as f:
        assert json.load(f) == want
    assert runs["ranks"][0] == runs["ranks"][1] == runs["single"]


def test_det_zip_holds_every_rank_s_images(runs):
    tmp = runs["tmp"]
    want = read_zip(os.path.join(tmp, "single", "toy_test_det.zip"))
    got = read_zip(os.path.join(tmp, "r0", "toy_test_det.zip"))
    assert sorted(got) == sorted(want) and len(want) == 5
    assert sum(len(v) for v in want.values()) >= 3, "too few words: the comparison tests little"
    for name in want:
        assert [t for _, t in got[name]] == [t for _, t in want[name]], name
        for (gc, _), (wc, _) in zip(got[name], want[name]):
            np.testing.assert_array_equal(gc, wc)


def test_rank0_alone_writes(runs):
    r1 = os.path.join(runs["tmp"], "r1")
    assert not os.path.exists(os.path.join(r1, "results.json"))
    assert not os.path.exists(os.path.join(r1, "toy_test_det.zip"))


def _dp_runner(model, devices, post_process=True):  # noqa: F811
    cfg = _runner(model, "TPU.SERVE_DATA_PARALLEL", "True").cfg
    return GlassRunner(cfg=cfg, state_dict=model, device="cpu", post_process=post_process,
                       serve_devices=devices)


@pytest.mark.parametrize("b", [3, 4])
def test_serve_data_parallel_equals_b1(model, b):  # noqa: F811
    """Raw outputs of every row: b = 3 pads one zero image."""
    imgs = [im.astype(np.float32) for im in images(6, b, (114, 160))]
    runner = _dp_runner(model, ["cpu", "cpu"], post_process=False)
    assert len(runner.replicas) == 2 and runner.replicas[1] is not runner.model
    got = runner.run_batch_on_resized(imgs)
    assert sum(len(p) for p in got) > 0, "no word survived: the case tests nothing"
    b1 = _runner(model, post_process=False)
    _assert_same(got, [b1.run_on_resized(im) for im in imgs])


def test_serve_data_parallel_eval_batch_call_and_one_device(model):  # noqa: F811
    """The whole ``eval_batch_call`` (batches of 3 and 1) on two replicas;
    one device keeps the one model (glass_tpu's no-op)."""
    imgs = images(7, 4)
    want = _runner(model).eval_batch_call(imgs, batch_size=1)
    _assert_same(_dp_runner(model, ["cpu", "cpu"]).eval_batch_call(imgs, batch_size=3), want)
    one = _dp_runner(model, ["cpu"])
    assert one.replicas == [one.model]
    _assert_same(one.eval_batch_call(imgs, batch_size=3), want)
