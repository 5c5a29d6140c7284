"""The port's visualizer (``glass_tpu_torch/utils/visualizer.py``, a copy of
glass_tpu's) and its demo, on the CPU.

Given the same predictions, texts and scores, ``visualize`` writes a PNG
whose pixels equal glass_tpu's (both render through matplotlib's Agg
backend in this process) and ``visualize_html`` the same HTML text, for
predictions with polygons, with boxes alone and with none.  ``python -m
glass_tpu_torch.demo --device cpu`` writes both forms as ``tools/demo.py``
does: ``.html`` the hover page, anything else the figure.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from glass_tpu.structures.instances import Instances as JInstances
from glass_tpu.utils import visualizer as J

from glass_tpu_torch import demo
from glass_tpu_torch.structures.instances import Instances
from glass_tpu_torch.utils import visualizer as T

torch.set_num_threads(2)
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "glass_finetune_icdar15.yaml")
TINY = ["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96", "TPU.IMAGE_BUCKETS", "[[96, 128]]",
        "TEST.DETECTIONS_PER_IMAGE", "8", "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
        "MODEL.RPN.POST_NMS_TOPK_TEST", "16", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "4",
        "TPU.COMPUTE_DTYPE", "float32"]
POLYGONS = np.array([[[10.0, 10.0], [60.0, 12.0], [59.0, 30.0], [9.0, 28.0]],
                     [[80.0, 50.0], [140.0, 50.0], [140.0, 70.0], [80.0, 70.0]],
                     [[30.0, 90.0], [70.0, 70.0], [78.0, 84.0], [38.0, 104.0]]])
BOXES = np.array([[40.0, 30.0, 50.0, 14.0, 10.0], [110.0, 60.0, 60.0, 20.0, -30.0],
                  [60.0, 95.0, 40.0, 12.0, 75.0]], np.float32)
TEXTS = ["hello", "<x&y>", "w0rd"]
SCORES = [0.91, 0.47, 0.66]
TEXT_SCORES = [0.88, 0.3, 0.5]
CHAR_SCORES = [[0.9, 0.8, 0.95, 0.99, 0.7], [0.5, 0.4, 0.3, 0.2, 0.1], [0.6, 0.7, 0.8, 0.9]]


def _image():
    return (np.random.RandomState(0).rand(120, 160, 3) * 255).astype(np.uint8)


def _preds(kind):
    """The same predictions as the port's and glass_tpu's Instances."""
    out = []
    for cls in (Instances, JInstances):
        inst = cls((120, 160))
        n = 0 if kind == "empty" else 3
        if kind == "polygons":
            inst.pred_polygons = POLYGONS
        if kind != "polygons":
            inst.pred_boxes = BOXES[:n]
        inst.scores = np.asarray(SCORES[:n])
        out.append(inst)
    return out


@pytest.mark.parametrize("kind", ["polygons", "boxes", "empty"])
def test_visualize_draws_glass_tpus_pixels(kind, tmp_path):
    port, ref = _preds(kind)
    n = len(port)
    T.visualize(_image(), port, TEXTS[:n], SCORES[:n], save_path=str(tmp_path / "port.png"), show_order=True)
    J.visualize(_image(), ref, TEXTS[:n], SCORES[:n], save_path=str(tmp_path / "ref.png"), show_order=True)
    got, want = cv2.imread(str(tmp_path / "port.png")), cv2.imread(str(tmp_path / "ref.png"))
    assert got is not None and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["polygons", "boxes", "empty"])
def test_visualize_html_writes_glass_tpus_text(kind, tmp_path):
    port, ref = _preds(kind)
    n = len(port)
    kw = dict(texts=TEXTS[:n], text_scores=TEXT_SCORES[:n], char_scores=CHAR_SCORES[:n], title="demo")
    got = T.visualize_html(_image(), port, save_path=str(tmp_path / "port.html"), **kw)
    want = J.visualize_html(_image(), ref, **kw)
    assert got == want
    assert (tmp_path / "port.html").read_text() == want
    assert got.count("<polygon") == n


def test_demo_writes_both_forms(tmp_path, capsys):
    image = str(tmp_path / "img.png")
    cv2.imwrite(image, (np.random.RandomState(0).rand(90, 110, 3) * 255).astype(np.uint8))
    for out in ("vis.png", "vis.html"):
        demo.main(["--image", image, "--config", CONFIG, "--output", str(tmp_path / out), "--device", "cpu",
                   *TINY])
        assert f"visualization written to {tmp_path / out}" in capsys.readouterr().out
    png = cv2.imread(str(tmp_path / "vis.png"))
    assert png is not None and png.ndim == 3
    html = (tmp_path / "vis.html").read_text()
    assert html.startswith("<!DOCTYPE html>") and "data:image/png;base64," in html
    assert "<title>img.png</title>" in html
