"""The milestone of the evaluation slice: ``python -m glass_tpu_torch.eval``
against ``tools/eval_glass.py`` on the same random ``.pth`` and images.

Both CLIs run over three synthetic images of rendered words (drawn as in
tests/test_learning_synthetic.py) in one 96 x 96 bucket, at f32, with the
opts of tests/test_eval_cli.py and post-processing thresholds loosened so
that a random model's words survive.  glass_tpu loads the ``.pth`` through
``load_any_checkpoint``, the port through its own loader.  The outputs must
agree: equal ``results.json``, det-zip polygons equal within the 1 px of
integer rounding, equal transcriptions.  Then the port's CLI scores its own
predictions with glass_tpu's det zip as the ground truth (``--gt-zip``):
detection and end-to-end hmean must both be 1.0.
"""

import importlib
import json
import os
import sys
import zipfile

import cv2
import numpy as np
import pytest
import torch

from glass_tpu_torch import eval as port_eval
from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference.runner import calibrate_batch_norm_, random_init_
from glass_tpu_torch.models import GlassArch, GlassRCNN

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICDAR15 = os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml")
OPTS = [
    "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
    "TPU.IMAGE_BUCKETS", "[[96, 96], [96, 128], [128, 96]]",
    "TEST.DETECTIONS_PER_IMAGE", "8",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "16",
    "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "4",
    "MODEL.ROI_MASK_HEAD.MASK_INFERENCE", "False",
    "TPU.COMPUTE_DTYPE", "float32", "POST_PROCESSING.VALID_CONFIDENCE", "0.05",
    "POST_PROCESSING.DETECT_THRESHOLD", "0.1", "POST_PROCESSING.TEXT_THRESHOLD", "0.0",
]
GLYPHS = {
    "a": ["11111", "10001", "10001", "11111", "10001", "10001", "10001"],
    "b": ["11110", "10001", "11110", "10001", "10001", "10001", "11110"],
    "c": ["01110", "10000", "10000", "10000", "10000", "10000", "01110"],
    "d": ["00100", "00100", "01110", "00100", "00100", "00100", "00100"],
    "e": ["10001", "01010", "00100", "00100", "00100", "01010", "10001"],
    "f": ["00100", "01110", "10101", "00100", "00100", "00100", "00100"],
}
WORDS = ["ace", "bdf", "fab", "ecd"]
H, W = 96, 112


def render_word(word, scale=3):
    img = np.zeros((7 * scale, 6 * len(word) * scale), np.uint8)
    for i, ch in enumerate(word):
        g = np.array([[int(c) for c in row] for row in GLYPHS[ch]], np.uint8)
        g = cv2.resize(g * 255, (5 * scale, 7 * scale), interpolation=cv2.INTER_NEAREST)
        img[:, i * 6 * scale: i * 6 * scale + 5 * scale] = g
    return img


def make_dataset(root, n_images=3, seed=0):
    os.makedirs(os.path.join(root, "ds", "toy_test"))
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i in range(n_images):
        img = np.full((H, W, 3), 40, np.uint8) + rng.randint(0, 20, (H, W, 3), dtype=np.uint8)
        for k in range(2):
            word = WORDS[(2 * i + k) % len(WORDS)]
            glyph = render_word(word, scale=2)
            gh, gw = glyph.shape
            x0, y0 = rng.randint(3, W - gw - 3), 6 + k * 44 + rng.randint(0, 20)
            img[y0 - 3: y0 + gh + 3, x0 - 3: x0 + gw + 3] = 0
            img[y0: y0 + gh, x0: x0 + gw] = glyph[..., None]
            quad = [[x0 - 3, y0 - 3], [x0 + gw + 3, y0 - 3], [x0 + gw + 3, y0 + gh + 3], [x0 - 3, y0 + gh + 3]]
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1, "category_id": 1,
                "bbox": [x0 - 3, y0 - 3, gw + 6, gh + 6], "rotated_box": quad,
                "segmentation": [[c for pt in quad for c in pt]], "rec": word,
                "angle": 0, "orientation": 0, "area": (gw + 6) * (gh + 6), "iscrowd": 0,
            })
        cv2.imwrite(os.path.join(root, "ds", "toy_test", f"img_{i}.png"), img)
        images.append({"id": i + 1, "file_name": f"img_{i}.png", "height": H, "width": W})
    with open(os.path.join(root, "ds", "toy_test", "annotations.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "word"}]}, f)
    path = os.path.join(root, "datasets.yaml")
    with open(path, "w") as f:
        f.write(f"ROOT: {os.path.join(root, 'ds')}\nDATASETS: []\nVAL_DATASETS:\n  - toy_test\n")
    return path, cv2.imread(os.path.join(root, "ds", "toy_test", "img_0.png"))


def save_random_model(path, image):
    """Seeded random weights, BN statistics calibrated on the first image as
    the CLIs see it (shortest edge 64, in its 96 x 96 bucket)."""
    cfg = get_cfg(ICDAR15, OPTS)
    resized = cv2.resize(image.astype(np.float32), (75, 64))
    pad = np.zeros((96, 96, 3), np.float32)
    pad[:64, :75] = resized
    model = random_init_(GlassRCNN(GlassArch.from_config(cfg)), seed=0).eval()
    calibrate_batch_norm_(model, torch.from_numpy(pad), (64, 75))
    torch.save(model.state_dict(), path)


def read_zip(path):
    """{image: [(coords, transcription), ...]} from a det zip."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in sorted(zf.namelist()):
            rows = []
            for line in zf.read(name).decode().splitlines():
                coords, text = line.split(",####", 1)
                rows.append((np.array([int(v) for v in coords.split(",")]), text))
            out[name] = rows
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("eval_cli"))
    ds_yaml, image = make_dataset(tmp)
    pth = os.path.join(tmp, "model.pth")
    save_random_model(pth, image)
    common = ["--config", ICDAR15, "--datasets", ds_yaml, "--model", pth]

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        eval_glass = importlib.import_module("eval_glass")
    finally:
        sys.path.pop(0)
    argv = sys.argv
    sys.argv = ["eval_glass.py", *common, "--output", os.path.join(tmp, "jax"), *OPTS]
    try:
        eval_glass.main()
    finally:
        sys.argv = argv
    port_eval.main([*common, "--output", os.path.join(tmp, "port"), "--device", "cpu", *OPTS])
    port_eval.main([*common, "--output", os.path.join(tmp, "vs_jax"), "--device", "cpu",
                    "--gt-zip", os.path.join(tmp, "jax", "toy_test_det.zip"), *OPTS])
    return tmp


def _results(tmp, name):
    with open(os.path.join(tmp, name, "results.json")) as f:
        return json.load(f)


def test_results_json_equal(runs):
    got, want = _results(runs, "port"), _results(runs, "jax")
    assert set(want["toy_test"]) == {"E2E_RESULTS", "DETECTION_ONLY_RESULTS"}
    assert got == want


def test_det_zip_polygons_and_transcriptions_equal(runs):
    got = read_zip(os.path.join(runs, "port", "toy_test_det.zip"))
    want = read_zip(os.path.join(runs, "jax", "toy_test_det.zip"))
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in want.values()) >= 3, "too few words: the comparison tests little"
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for (gc, gt), (wc, wt) in zip(got[name], want[name]):
            assert np.abs(gc - wc).max() <= 1, (name, gc, wc)
            assert gt == wt, (name, gt, wt)


def test_port_scores_one_against_glass_tpu_detections(runs):
    res = _results(runs, "vs_jax")["toy_test"]
    assert res["DETECTION_ONLY_RESULTS"]["hmean"] == 1.0
    assert res["E2E_RESULTS"]["hmean"] == 1.0


def test_per_sample_json_equal(runs):
    with open(os.path.join(runs, "port", "toy_test_per_sample.json")) as f:
        got = json.load(f)
    with open(os.path.join(runs, "jax", "toy_test_per_sample.json")) as f:
        want = json.load(f)
    assert got == want


def test_tta_and_multi_process_raise(runs, tmp_path, monkeypatch):
    """``--tta`` is ported (tests/test_torch_tta.py holds it against
    tools/eval_glass.py --tta): here it evaluates with one view.  More than
    one process is ported too (tests/test_torch_distributed_eval.py runs two
    gloo ranks): as rank 1 of 2, the CLI evaluates the strided shard
    ``records[1::2]``, hands it to the gather and writes no results.json."""
    args = ["--config", ICDAR15, "--output", str(tmp_path), "--device", "cpu"]
    common = ["--datasets", os.path.join(runs, "datasets.yaml"), "--model", os.path.join(runs, "model.pth")]
    res = port_eval.main(args + common + ["--tta", "--max-images", "1", *OPTS,
                                          "TEST.AUG.MIN_SIZES", "[64]", "TEST.AUG.FLIP", "False"])
    assert set(res["toy_test"]) == {"E2E_RESULTS", "DETECTION_ONLY_RESULTS"}
    assert os.path.exists(os.path.join(tmp_path, "results.json"))
    import torch.distributed as dist

    from glass_tpu_torch.evaluation import TextEvaluator

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    gathered = []
    monkeypatch.setattr(TextEvaluator, "gather_across_processes",
                        lambda self: gathered.append(sorted(self._dets)))
    out = tmp_path / "rank1"
    port_eval.main(["--config", ICDAR15, "--output", str(out), "--device", "cpu", *common, *OPTS])
    assert gathered == [["2"]]  # image ids 1, 2, 3: rank 1 of 2 takes the second
    assert not os.path.exists(out / "results.json") and not os.path.exists(out / "toy_test_det.zip")
