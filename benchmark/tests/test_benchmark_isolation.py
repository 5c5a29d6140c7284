"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program: top-level module names
compared whole (``glass_tpu_torch`` begins with ``glass_tpu``)."""

import ast
import json
import os
import subprocess
import sys

from benchmark.harness.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "glass_tpu"}


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(imports(p)) & FORBIDDEN) for p in sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_reference_imports_nothing_of_the_program_nor_of_the_harness():
    for p in sources("reference"):
        assert not set(imports(p)) & (FORBIDDEN | {"glass_tpu_torch", "benchmark"}), p


def test_whole_names_are_compared(monkeypatch):
    from benchmark.run import forbidden_modules

    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "glass_tpu_torch.lookalike", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "glass_tpu.anything", sys)
    assert forbidden_modules() == ["glass_tpu"]


def test_a_cpu_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        "from benchmark import run\n"
        "from benchmark.tests.tiny import SERVE, EVAL_MIX\n"
        "rc = run.main(['--workload', 'icdar15.eval_b4_dense', '--seed', '5', '--seconds', '0.1', '--trace', '0'],"
        " device='cpu', opts=SERVE, mix_overrides=EVAL_MIX)\n"
        "import benchmark.reference.train, benchmark.control\n"
        "print(json.dumps({'rc': rc, 'top': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert not set(got["top"]) & FORBIDDEN
    assert "glass_tpu_torch" in got["top"]


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, benchmark.reference.runner, benchmark.reference.train\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"glass_tpu_torch"})
