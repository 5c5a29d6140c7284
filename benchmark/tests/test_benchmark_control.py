"""The comparison fails what it has to fail.

* The control (the reference one precision below the configuration,
  ``benchmark/control.py``) comes out as not correct in every cell.
* The rest of a run, driven with the timed path broken underneath, sees
  ``correct`` come out false for each fault the cell can have: a token
  altered where it is produced (the serving cells), half of the batch left
  out (batched evaluation), a step that returns its state unchanged
  (training).  One chip, so no exchange between chips to leave out.
"""

import json

import pytest
import torch

from benchmark import control
from benchmark.harness.spec import Cell, load_spec
from benchmark.tests.test_benchmark_dry_run import dry
from benchmark.tests.tiny import tiny

SPEC = load_spec()


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_control_is_not_correct(workload, capsys):
    cell = Cell(SPEC, workload)
    opts, mix = tiny(cell.traffic)
    rc = control.main(["--workload", workload, "--seeds", "3"], device="cpu", opts=opts, mix_overrides=mix)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False


def _least_likely_token(monkeypatch):
    from glass_tpu_torch.models import glass_rcnn

    real = glass_rcnn.emit_text

    def altered(arch, probs):
        out = real(arch, probs)
        out["text_ids"] = torch.argmin(probs, dim=-1).to(torch.int32)
        return out

    monkeypatch.setattr(glass_rcnn, "emit_text", altered)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]
                                      if w["traffic"] != "train_b1"])
def test_a_token_altered_where_it_is_produced_is_caught(workload, monkeypatch, capsys):
    _least_likely_token(monkeypatch)
    rc, line, _ = dry(workload, 0, capsys)
    assert rc == 0 and line["correct"] is False
    assert line["compared"]["text_gap"]["value"] > line["compared"]["text_gap"]["limit"]


def test_half_of_the_batch_left_out_is_caught(monkeypatch, capsys):
    from glass_tpu_torch.inference import runner as runner_mod

    real = runner_mod.GlassRunner.batch_model_fn

    def half(self):
        fn = real(self)

        def program(imgs, hws):
            k = max(1, imgs.shape[0] // 2)
            out = fn(imgs[:k], hws[:k])
            reps = -(-imgs.shape[0] // k)
            return {key: v.repeat((reps,) + (1,) * (v.dim() - 1))[:imgs.shape[0]] for key, v in out.items()}
        return program

    monkeypatch.setattr(runner_mod.GlassRunner, "batch_model_fn", half)
    rc, line, _ = dry("icdar15.eval_b4_dense", 0, capsys, extra={"compare": 4})
    assert rc == 0 and line["correct"] is False


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch, capsys):
    from glass_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.GlassOptimizer, "step", lambda self, iteration: 0.0)
    rc, line, _ = dry("pretrain.train_b1", 0, capsys)
    assert rc == 0 and line["correct"] is False
    for name in ("change_gap", "grad_gap", "grad_gap_group", "change_gap_group", "grad_diff", "change_diff"):
        assert line["compared"][name]["value"] == pytest.approx(1.0)
