"""``python -m glass_tpu_torch.tools.verify_released_checkpoint`` against
``tools/verify_released_checkpoint.py`` on the same released-like ``.pth``.

The checkpoint is tests/test_torch_eval_cli.py's seeded, BN-calibrated model
in the layout of a released file (``{"model": state_dict, "iteration": 0}``),
the dataset its three glyph scenes, the opts its small f32 ones.  Both tools
run ``--dry-run`` on them (glass_tpu's through ``tools/eval_glass.py``, the
port's through ``glass_tpu_torch.eval`` with ``--device cpu``): the reports
must be equal apart from paths, the det zips' polygons within 1 px with equal
transcriptions.  The port's tool then scores its predictions against
glass_tpu's det zip (``--gt-zip``): hmean 1.0, so it passes at an expected
1.0 and fails with exit 1 at 0.5.  The rest needs no eval: the table of
released files, the download cache, the argument rules, the load check and
the refusal to run on a GPU that is not there.
"""

import importlib
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from glass_tpu_torch.tools import verify_released_checkpoint as port_verify
from glass_tpu_torch.train.checkpoint import load_torch_checkpoint
from tests.test_torch_eval_cli import ICDAR15, OPTS, make_dataset, read_zip, save_random_model

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _glass_tpu_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        return importlib.import_module("verify_released_checkpoint")
    finally:
        sys.path.pop(0)


jax_verify = _glass_tpu_tool()


def released_like(path, state_dict):
    torch.save({"model": state_dict, "iteration": 0}, path)
    return path


def _report(out):
    with open(os.path.join(out, "verification_report.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("verify_released"))
    ds_yaml, image = make_dataset(tmp)
    bare = os.path.join(tmp, "bare.pth")
    save_random_model(bare, image)
    pth = released_like(os.path.join(tmp, "released_like.pth"), torch.load(bare))
    common = ["--dry-run", "--checkpoint", pth, "--config", ICDAR15, "--datasets", ds_yaml]
    rcs = {"jax": jax_verify.main([*common, "--output", os.path.join(tmp, "jax"), *OPTS])}
    port = [*common, "--device", "cpu"]
    rcs["port"] = port_verify.main([*port, "--output", os.path.join(tmp, "port"), *OPTS])
    gt = ["--gt-zip", os.path.join(tmp, "jax", "toy_test_det.zip"), "--tolerance", "0.01"]
    for name, expected in (("pass", "1.0"), ("fail", "0.5")):
        rcs[name] = port_verify.main([*port, *gt, "--expected-hmean", expected,
                                      "--output", os.path.join(tmp, name), *OPTS])
    return tmp, pth, rcs


def test_dry_run_reports_equal_glass_tpus(runs):
    tmp, pth, rcs = runs
    assert rcs["jax"] == rcs["port"] == 0  # no expected value: recorded, passed
    got, want = _report(os.path.join(tmp, "port")), _report(os.path.join(tmp, "jax"))
    assert set(got) == set(want) == {"checkpoint", "config", "measured_hmean", "expected_hmean",
                                     "tolerance", "results", "pass"}
    for key in ("measured_hmean", "results", "pass", "expected_hmean", "tolerance"):
        assert got[key] == want[key], key
    assert got["checkpoint"] == want["checkpoint"] == pth
    assert got["pass"] is True and got["expected_hmean"] is None
    assert 0.0 <= got["measured_hmean"] <= 1.0


def test_dry_run_det_zips_equal_glass_tpus(runs):
    tmp = runs[0]
    got = read_zip(os.path.join(tmp, "port", "toy_test_det.zip"))
    want = read_zip(os.path.join(tmp, "jax", "toy_test_det.zip"))
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in want.values()) >= 3, "too few words: the comparison tests little"
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for (gc, gt), (wc, wt) in zip(got[name], want[name]):
            assert np.abs(gc - wc).max() <= 1, (name, gc, wc)
            assert gt == wt, (name, gt, wt)


def test_gate_passes_against_glass_tpus_detections(runs):
    tmp, _, rcs = runs
    report = _report(os.path.join(tmp, "pass"))
    assert rcs["pass"] == 0
    assert report["measured_hmean"] == 1.0 and report["diff"] == 0.0 and report["pass"] is True
    assert report["results"]["toy_test"]["DETECTION_ONLY_RESULTS"]["hmean"] == 1.0


def test_gate_fails_at_half(runs):
    tmp, _, rcs = runs
    report = _report(os.path.join(tmp, "fail"))
    assert rcs["fail"] == 1
    assert report["pass"] is False and report["expected_hmean"] == 0.5 and report["diff"] == 0.5


def test_tensor_count_against_glass_tpus_leaves(runs):
    """The port counts the tensors its loader returns, glass_tpu the leaves
    of its parameter tree.  For a d2 file the two counts are equal: the
    file's tensors less BN's ``num_batches_tracked``, which both loaders
    drop."""
    import jax

    from glass_tpu.train.checkpoint import load_any_checkpoint

    pth = runs[1]
    raw = torch.load(pth)["model"]
    dropped = [k for k in raw if k.endswith("num_batches_tracked")]
    n_leaves = len(jax.tree_util.tree_leaves(load_any_checkpoint(pth)))
    assert port_verify.count_tensors(pth) == len(load_torch_checkpoint(pth)) == n_leaves
    assert n_leaves == len(raw) - len(dropped)
    assert n_leaves >= 100  # the full-run threshold: the real model passes it


@pytest.mark.parametrize("tool", ["port", "glass_tpu"])
def test_small_checkpoint_is_refused(tool, tmp_path):
    """Three tensors are below the dry run's 5: both tools refuse before
    any eval, with the same message."""
    names = ["backbone.bottom_up.stem.conv1.weight", "proposal_generator.rpn_head.conv.weight",
             "proposal_generator.rpn_head.conv.bias"]
    rng = np.random.RandomState(0)
    pth = released_like(str(tmp_path / "tiny.pth"),
                        {n: torch.from_numpy(rng.rand(4, 3).astype(np.float32)) for n in names})
    argv = ["--dry-run", "--checkpoint", pth, "--config", ICDAR15, "--output", str(tmp_path / "out")]
    main = port_verify.main if tool == "port" else jax_verify.main
    with pytest.raises(SystemExit, match=r"^conversion produced only 3 leaves$"):
        main(argv + (["--device", "cpu"] if tool == "port" else []))
    assert not os.path.exists(tmp_path / "out" / "verification_report.json")


def test_released_table_equals_glass_tpus():
    assert port_verify.RELEASED == jax_verify.RELEASED
    assert set(port_verify.RELEASED) == {"icdar15", "totaltext", "textocr"}


@pytest.mark.parametrize("argv", [
    [],
    ["--model", "textocr", "--batch-size", "4", "--max-images", "7", "--word-spotting"],
    ["--checkpoint", "a.pth", "--config", "b.yaml", "--expected-hmean", "0.847", "--tolerance", "0.01",
     "--dry-run", "--dataset-root", "/d", "--gt-zip", "gt.zip", "--cache-dir", "c", "--output", "o",
     "INPUT.MIN_SIZE_TEST", "64"],
], ids=["defaults", "model", "paths"])
def test_parse_args_as_glass_tpus_plus_device(argv):
    got = vars(port_verify.parse_args(argv))
    assert got.pop("device") is None
    assert got == vars(jax_verify.parse_args(argv))
    assert port_verify.parse_args(["--device", "cpu", *argv]).device == "cpu"


def _no_network(*args, **kwargs):
    raise AssertionError("the network was reached")


def test_download_uses_a_cached_file(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlretrieve", _no_network)
    dest = tmp_path / "cache" / "m.pth"
    dest.parent.mkdir()
    dest.write_bytes(b"x")
    assert port_verify._download("https://example.invalid/m.pth", str(dest)) == str(dest)


def test_download_goes_through_urllib_to_a_part_file(tmp_path, monkeypatch):
    """An empty or missing file is fetched (here by a stand-in for
    ``urlretrieve``) into ``<dest>.part``, then moved into place."""
    calls = []

    def fetch(url, path):
        calls.append((url, path))
        with open(path, "wb") as f:
            f.write(b"weights")

    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    dest = tmp_path / "cache" / "sub" / "m.pth"
    assert port_verify._download("https://example.invalid/m.pth", str(dest)) == str(dest)
    assert calls == [("https://example.invalid/m.pth", str(dest) + ".part")]
    assert dest.read_bytes() == b"weights" and not os.path.exists(str(dest) + ".part")


def test_resolve_artifacts_reads_the_cache_for_a_released_model(tmp_path, monkeypatch):
    monkeypatch.setattr(urllib.request, "urlretrieve", _no_network)
    urls = port_verify.RELEASED["icdar15"]
    for url in urls.values():
        (tmp_path / os.path.basename(url)).write_bytes(b"x")
    args = port_verify.parse_args(["--model", "icdar15", "--cache-dir", str(tmp_path)])
    want = tuple(str(tmp_path / os.path.basename(urls[k])) for k in ("checkpoint", "config"))
    assert port_verify.resolve_artifacts(args) == want
    local = port_verify.parse_args(["--model", "icdar15", "--cache-dir", str(tmp_path), "--config", "own.yaml"])
    assert port_verify.resolve_artifacts(local) == (want[0], "own.yaml")


@pytest.mark.parametrize("argv", [[], ["--checkpoint", "a.pth"], ["--config", "b.yaml"]],
                         ids=["neither", "checkpoint_only", "config_only"])
def test_resolve_artifacts_needs_model_or_both_paths(argv):
    with pytest.raises(SystemExit) as want:
        jax_verify.resolve_artifacts(jax_verify.parse_args(argv))
    with pytest.raises(SystemExit) as got:
        port_verify.resolve_artifacts(port_verify.parse_args(argv))
    assert str(got.value) == str(want.value) == "need --model (to download) or both --checkpoint and --config"


def test_eval_argv_is_glass_tpus_plus_device(monkeypatch, tmp_path):
    """glass_tpu's tool runs ``tools/eval_glass.py`` with an argv; the port's
    runs ``glass_tpu_torch.eval.main`` with the same one plus ``--device``."""
    import runpy

    seen = {}

    def fake_run_path(path, run_name=None):
        seen["jax"] = list(sys.argv[1:])
        with open(os.path.join(str(tmp_path), "results.json"), "w") as f:
            json.dump({"d": {"E2E_RESULTS": {"hmean": 0.25}}}, f)

    monkeypatch.setattr(runpy, "run_path", fake_run_path)
    argv = ["--checkpoint", "a.pth", "--config", "b.yaml", "--datasets", "d.yaml", "--gt-zip", "gt.zip",
            "--word-spotting", "--max-images", "5", "--batch-size", "4", "--dataset-root", "/data",
            "--output", str(tmp_path), "INPUT.MIN_SIZE_TEST", "64"]
    assert jax_verify.run_eval(jax_verify.parse_args(argv), "a.pth", "b.yaml") == {
        "d": {"E2E_RESULTS": {"hmean": 0.25}}}
    got = port_verify.eval_argv(port_verify.parse_args(argv), "a.pth", "b.yaml", "cpu")
    assert got[6:8] == ["--device", "cpu"]
    assert got[:6] + got[8:] == seen["jax"]
    assert port_verify.extract_hmean({"d": {"E2E_RESULTS": {"hmean": 0.25}}}) == 0.25


def test_refuses_cuda_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--checkpoint", "a.pth", "--config", ICDAR15, "--output", str(tmp_path / "out")]
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="is_available"):
            port_verify.main(argv + device)
    assert not os.path.exists(tmp_path / "out")
