"""A CPU run of each cell at a tiny size prints a well-formed last line:
the contract's keys, the device saying CPU and no device metric filled, and
``correct`` true (the program at float32 on the CPU against the plain
reference)."""

import json

import pytest

from benchmark import run
from benchmark.harness.spec import load_spec
from benchmark.tests.tiny import tiny

SPEC = load_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def dry(workload, trace, capsys, seed=2 ** 31 + 12345, extra=None):
    from benchmark.harness.spec import Cell

    cell = Cell(SPEC, workload)
    opts, mix = tiny(cell.traffic)
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace)],
                  device="cpu", opts=opts, mix_overrides={**mix, **(extra or {})})
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_tiny_cpu_run_prints_a_well_formed_line(workload, trace, capsys):
    rc, line, err = dry(workload, trace, capsys)
    assert rc == 0
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "compared"
    assert line["device"]["platform"] == "cpu" and line["device"]["memory_peak_bytes"] is None
    assert all(m["value"] is None for m in line["metrics"].values())
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    if trace == 0:
        from benchmark.harness.spec import Cell

        assert set(line["metrics"]) == {m["name"] for m in Cell(SPEC, workload).end_to_end}
    for name, c in line["compared"].items():
        assert f"{name} " in err and c["value"] is not None


def test_the_cell_names_no_device_when_there_is_none(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""


def test_a_directory_of_the_benchmark_alone_cannot_run(tmp_path):
    import os
    import shutil
    import subprocess
    import sys

    from benchmark.harness.spec import HERE, ROOT

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", WORKLOADS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
