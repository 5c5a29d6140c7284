"""Rules the port keeps: glass_tpu_torch (and chip_smoke.py) never import
jax or glass_tpu (nor python-Levenshtein, which the card machine lacks),
its weights carry across from glass_tpu's parameter tree, and its entry
points refuse to run on a GPU that is not there."""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from glass_tpu.config import get_cfg as j_get_cfg
from glass_tpu.models import GlassArch as JArch
from glass_tpu.models import init_glass_params

from glass_tpu_torch.config import get_cfg
from glass_tpu_torch.inference import GlassRunner
from glass_tpu_torch.models import GlassArch, GlassRCNN
from glass_tpu_torch.weights import state_dict_from_jax_params

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "glass_tpu_torch")
ICDAR15 = os.path.join(ROOT, "configs", "glass_finetune_icdar15.yaml")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "glass_tpu", "Levenshtein")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PACKAGE):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _submodules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, ROOT)[: -len(".py")].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def _is_forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_jax_or_glass_tpu(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _is_forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str) and _is_forbidden(a.value)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_every_submodule_loads_no_jax():
    """In a fresh interpreter (this one already holds jax from conftest)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_submodules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('LOADED', len([m for m in sys.modules if m.startswith('glass_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"LOADED {len(_submodules())} []" in res.stdout


def test_weights_map_icdar15_params_onto_the_port_state_dict():
    """init_glass_params at the ICDAR15 architecture -> the port's
    state_dict: the same key set, each with its shape."""
    jarch = JArch.from_config(j_get_cfg(ICDAR15))
    params = jax.tree_util.tree_map(np.asarray, init_glass_params(jax.random.PRNGKey(0), jarch))
    sd = state_dict_from_jax_params(params)
    own = GlassRCNN(GlassArch.from_config(get_cfg(ICDAR15))).state_dict()
    assert set(sd) == set(own)
    wrong = {k: (tuple(sd[k].shape), tuple(v.shape)) for k, v in own.items()
             if tuple(sd[k].shape) != tuple(v.shape)}
    assert not wrong, wrong
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_runner_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg(ICDAR15)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="is_available"):
            GlassRunner(cfg=cfg, device=device)


def test_the_scans_cover_the_measurement_entry_points():
    """The AST scan and the fresh-interpreter import above reach the one
    ``glass_tpu_torch.tools`` module, ``verify_released_checkpoint``."""
    tools = sorted(n[:-3] for n in os.listdir(os.path.join(PACKAGE, "tools")) if n.endswith(".py"))
    assert tools == ["__init__", "verify_released_checkpoint"]
    assert "glass_tpu_torch.tools.verify_released_checkpoint" in set(_submodules())
    assert os.path.join(PACKAGE, "tools", "verify_released_checkpoint.py") in set(_port_files())
