"""The port's evaluator against glass_tpu's on the same seeded inputs.

Polygon areas and IoU (native and Python paths), the RRC protocol's
results dicts (``evaluate_dataset`` with per-sample records and
confidences, word spotting), RRC zip validation, lexicon matching, the
det-zip writer and gt-zip reader of ``TextEvaluator``, and the port's own
edit distance against ``Levenshtein.distance``.  Results must be equal.
"""

import io
import os
import subprocess
import sys
import zipfile

import Levenshtein
import numpy as np
import pytest
import torch

import glass_tpu.evaluation as J
import glass_tpu.evaluation.polygon as j_polygon
from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.native import load_polyclip as j_load_polyclip
from glass_tpu.structures import Instances as JInstances

import glass_tpu_torch.evaluation as T
import glass_tpu_torch.evaluation.polygon as t_polygon
from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.native import load_polyclip, polyclip_path
from glass_tpu_torch.structures import Instances

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = "abcdeABCDE0123'!?.-# "


def _quad(rng, cx=None, cy=None):
    cx = rng.uniform(20, 300) if cx is None else cx
    cy = rng.uniform(20, 200) if cy is None else cy
    w, h, a = rng.uniform(10, 80), rng.uniform(6, 30), np.deg2rad(rng.uniform(-40, 40))
    c, s = np.cos(a), np.sin(a)
    corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
    return corners @ np.array([[c, s], [-s, c]]) + [cx, cy]


def _concave(rng):
    """A simple concave polygon (a star) — curved-text masks are concave."""
    n = rng.randint(5, 9)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = np.where(np.arange(n) % 2, 8.0, 20.0) * rng.uniform(0.8, 1.2, n)
    return np.stack([100 + r * np.cos(ang), 100 + r * np.sin(ang)], 1)


def _polys(seed, n=12):
    rng = np.random.RandomState(seed)
    out = [_quad(rng, 100 + rng.uniform(-15, 15), 100 + rng.uniform(-10, 10)) for _ in range(n // 2)]
    return out + [_concave(rng) for _ in range(n - n // 2)]


def test_native_polyclip_builds_in_the_build_dir():
    lib = load_polyclip()
    assert lib is not None and polyclip_path() == "native"
    from glass_tpu_torch.native.build import build_dir, library_path

    assert os.path.dirname(library_path()) == build_dir()
    assert os.path.exists(library_path())


def test_polyclip_build_failure_falls_back_to_python(tmp_path, monkeypatch):
    """No g++ (or a failed build): a warning, and the Python polygon path."""
    from glass_tpu_torch.native import build

    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    warned = []
    monkeypatch.setenv("GLASS_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_path", None)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build.subprocess, "run", no_compiler)
    monkeypatch.setattr(build.logger, "warning", lambda msg, *a: warned.append(msg % a))
    assert load_polyclip() is None
    assert polyclip_path() == "python"
    assert len(warned) == 1 and "using the python path" in warned[0]
    p, q = _polys(4), _polys(5)
    monkeypatch.setattr(j_polygon, "_native", lambda: None)
    np.testing.assert_array_equal(t_polygon.pairwise_polygon_iou(p, q), j_polygon.pairwise_polygon_iou(p, q))


@pytest.mark.parametrize("seed", [0, 1])
def test_polyclip_matches_glass_tpu(seed):
    p, q = _polys(seed), _polys(seed + 10)
    jl, tl = j_load_polyclip(), load_polyclip()
    np.testing.assert_array_equal(tl.pairwise_iou(p, q), jl.pairwise_iou(p, q))
    np.testing.assert_array_equal(tl.pairwise_ioa_first(p, q), jl.pairwise_ioa_first(p, q))
    for a, b in zip(p, q):
        assert tl.intersection_area(a, b) == jl.intersection_area(a, b)
        assert tl.area(a) == jl.area(a)


@pytest.mark.parametrize("path", ["native", "python"])
def test_polygon_iou_matches_glass_tpu(path, monkeypatch):
    if path == "python":  # the fallback without the native library
        monkeypatch.setattr(t_polygon, "_native", lambda: None)
        monkeypatch.setattr(j_polygon, "_native", lambda: None)
    p, q = _polys(2), _polys(3)
    np.testing.assert_array_equal(t_polygon.pairwise_polygon_iou(p, q), j_polygon.pairwise_polygon_iou(p, q))
    for a, b in zip(p, q):
        assert t_polygon.polygon_area(a) == j_polygon.polygon_area(a)
        assert t_polygon.polygon_iou(a, b) == j_polygon.polygon_iou(a, b)


def _random_word(rng, lo=0, hi=7):
    return "".join(rng.choice(list(ALPHABET), rng.randint(lo, hi)))


def _dataset(seed, images=6):
    """gts and dets per image: matched, shifted, don't-care and extra words."""
    rng = np.random.RandomState(seed)
    gts, dets = {}, {}
    for k in range(images):
        g, d = [], []
        for _ in range(rng.randint(0, 6)):
            quad = _quad(rng)
            word = rng.choice(["###", _random_word(rng, 1), "'tis!", "HELLO", "ab-cd's"])
            g.append((quad, word))
            r = rng.rand()
            if r < 0.6:     # detected, maybe a little off, maybe misread
                text = word if rng.rand() < 0.6 else _random_word(rng)
                d.append((quad + rng.uniform(-3, 3, quad.shape), text.strip("#") or "x"))
            elif r < 0.8:   # detected far off
                d.append((quad + 40, word))
        for _ in range(rng.randint(0, 3)):  # spurious
            d.append((_quad(rng), _random_word(rng)))
        gts[str(k)] = g
        dets[str(k)] = [(q, t, float(rng.rand())) for q, t in d]
    return gts, dets


def _to(mod, gts, dets):
    g = {k: [mod.EvalInstance(points=q, transcription=t) for q, t in v] for k, v in gts.items()}
    d = {k: [mod.EvalInstance(points=q, transcription=t, confidence=c) for q, t, c in v]
         for k, v in dets.items()}
    return g, d


@pytest.mark.parametrize("word_spotting", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_dataset_matches_glass_tpu(seed, word_spotting):
    gts, dets = _dataset(seed)
    jps, tps = {}, {}
    want = J.evaluate_dataset(*_to(J, gts, dets), word_spotting, per_sample=jps, confidences=True)
    got = T.evaluate_dataset(*_to(T, gts, dets), word_spotting, per_sample=tps, confidences=True)
    assert got == want
    assert tps == jps
    assert 0 < want["DETECTION_ONLY_RESULTS"]["hmean"] < 1


def _zip(entries):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for name, text in entries.items():
            zf.writestr(name, text)
    return buf.getvalue()


ZIP_CASES = {
    "ok": ({"gt_img_1.txt": "1,2,30,2,30,20,1,20,word\r\n4,5,40,5,40,25,4,25,###\n"},
           {"res_img_1.txt": "1,2,30,2,30,20,1,20,####word\n"}),
    "bad gt": ({"gt_img_1.txt": "1,2,30,2,30,20,word\n"}, {"res_img_1.txt": "1,2,3,4,5,6,####a\n"}),
    "bad det": ({"gt_img_1.txt": "1,2,30,2,30,20,1,20,word\n"}, {"res_img_1.txt": "1,2,3,4,5,####a\n"}),
    "det not in gt": ({"gt_img_1.txt": "1,2,30,2,30,20,1,20,w\n"}, {"res_img_2.txt": "1,2,3,4,5,6,####a\n"}),
    "quoted": ({"gt_img_7.txt": '1,2,30,2,30,20,1,20,"a\\"b"\n'}, {"res_img_7.txt": "1,2,3,4,5,6,####ab\n"}),
}


@pytest.mark.parametrize("case", sorted(ZIP_CASES))
def test_rrc_validation_matches_glass_tpu(case, tmp_path):
    gt, det = ZIP_CASES[case]
    (tmp_path / "gt.zip").write_bytes(_zip(gt))
    (tmp_path / "det.zip").write_bytes(_zip(det))
    args = (str(tmp_path / "gt.zip"), str(tmp_path / "det.zip"))

    def run(fn):
        try:
            return ("ok", fn())
        except Exception as e:  # the message is part of the contract
            return (type(e).__name__, str(e))

    assert run(lambda: T.validate_submission(*args)) == run(lambda: J.validate_submission(*args))
    for strict in (True, False):
        got = run(lambda: _flat(T.load_gt_zip(args[0], r"gt_img_([0-9]+)", strict=strict)))
        assert got == run(lambda: _flat(J.load_gt_zip(args[0], r"gt_img_([0-9]+)", strict=strict)))


def _flat(insts):
    return {k: [(np.asarray(i.points).tolist(), i.transcription) for i in v] for k, v in insts.items()}


def test_lexicon_matching_matches_glass_tpu(tmp_path):
    rng = np.random.RandomState(5)
    words = sorted({_random_word(rng, 2, 9).strip() or "q" for _ in range(300)})
    (tmp_path / "lex.txt").write_text("\n".join(words) + "\n")
    (tmp_path / "pairs.txt").write_text("\n".join(f"{w.upper()} {w}" for w in words) + "\n")
    (tmp_path / "new_voc_img_3.txt").write_text("\n".join(words[:40]) + "\n")
    queries = [_random_word(rng, 0, 9) for _ in range(80)] + words[:5]
    codec_chars = sorted(set(ALPHABET.upper() + ALPHABET))
    enc = {c: i for i, c in enumerate(codec_chars)}
    for lex_type in (1, 2, 3):
        for weighted in (False, True):
            kw = dict(lexicon_type=lex_type, strong_dir=str(tmp_path), weighted=weighted)
            if lex_type != 3:
                kw.update(words=words, pairs=J.lexicon.load_pairs_file(str(tmp_path / "pairs.txt")))
            js, ts = J.LexiconSet(**kw), T.LexiconSet(**kw)
            for q in queries:
                probs = rng.dirichlet(np.ones(len(codec_chars)), max(len(q), 1))
                args = dict(image_id="3", char_probs=probs if weighted else None, char_encode=enc.get)
                assert ts.correct(q, **args) == js.correct(q, **args), (lex_type, weighted, q)
    jl, tl = J.Lexicon.from_file(str(tmp_path / "lex.txt")), T.Lexicon.from_file(str(tmp_path / "lex.txt"))
    for q in queries:
        assert tl.correct(q) == jl.correct(q)
        for ws in (False, True):
            assert T.match_transcript(q, ws) == J.match_transcript(q, ws)
            assert T.text_eval.include_in_dictionary(q or "x") == J.text_eval.include_in_dictionary(q or "x")


def test_edit_distance_equals_levenshtein():
    rng = np.random.RandomState(7)
    pairs = [("", ""), ("", "abc"), ("kitten", "sitting"), ("flaw", "lawn"), ("AbC", "abc")]
    pairs += [(_random_word(rng, 0, 12), _random_word(rng, 0, 12)) for _ in range(400)]
    pairs += [("ä" + _random_word(rng), "ü" + _random_word(rng)) for _ in range(20)]
    for a, b in pairs:
        assert T.edit_distance(a, b) == Levenshtein.distance(a, b), (a, b)


def test_evaluation_imports_without_levenshtein():
    code = (
        "import sys\n"
        "sys.modules['Levenshtein'] = None  # any import of it now fails\n"
        "import glass_tpu_torch.evaluation as ev\n"
        "assert ev.edit_distance('abc', 'axc') == 1\n"
        "print('IMPORTED', sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'glass_tpu')))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "IMPORTED []" in res.stdout


def _preds(mod, seed, n=5):
    rng = np.random.RandomState(seed)
    boxes = np.stack([rng.uniform(20, 200, n), rng.uniform(20, 150, n), rng.uniform(10, 60, n),
                      rng.uniform(6, 20, n), rng.uniform(-30, 30, n)], 1).astype(np.float32)
    ids = rng.randint(1, 60, (n, 6)).astype(np.int32)
    ids[:, 4:] = 0
    return mod((240, 320), pred_boxes=boxes, scores=rng.rand(n).astype(np.float32),
               pred_text_ids=ids, pred_text_step_scores=rng.rand(n, 6).astype(np.float32))


def test_text_evaluator_outputs_match_glass_tpu(tmp_path):
    """process -> evaluate: results, the per-sample JSON and the det zip;
    then a gt zip read back through both."""
    opts = ["MODEL.ROI_MASK_HEAD.MASK_INFERENCE", "False"]
    outs = {}
    for name, mod, cfg, inst in (("j", J, j_get_cfg(None, opts), JInstances),
                                 ("t", T, get_cfg(None, opts), Instances)):
        out = tmp_path / name
        ev = mod.TextEvaluator("toy_test", cfg, output_dir=str(out))
        for k in range(3):
            record = {"annotations": [
                {"bbox": [60, 60, 40, 12, 5], "text": "word"},
                {"segmentation": [[10, 10, 50, 10, 50, 30, 10, 30]], "text": ""},
            ]}
            ev.process(str(k), _preds(inst, k), gt_record=record)
        outs[name] = (ev.evaluate(), (out / "toy_test_per_sample.json").read_text(),
                      {n: zipfile.ZipFile(out / "toy_test_det.zip").read(n)
                       for n in zipfile.ZipFile(out / "toy_test_det.zip").namelist()})
    assert outs["t"] == outs["j"]
    zpath = str(tmp_path / "t" / "toy_test_det.zip")
    assert (_flat(T.load_gt_zip(zpath, strict=True, line_format="totaltext"))
            == _flat(J.load_gt_zip(zpath, strict=True, line_format="totaltext")))
