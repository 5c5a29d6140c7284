"""On the card: one short run of each cell at its own size, traced and not,
comes out correct with a well-formed line.  Skips without a CUDA device
(decided in the fixture)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness.spec import ROOT, load_spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run only on the card")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in load_spec()["workloads"]])
def test_a_cell_runs_on_the_card(card, workload, trace):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", "2147483659",
                          "--seconds", "5", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=1200, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["metrics"]
