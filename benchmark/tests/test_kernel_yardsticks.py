"""Each kernel's yardstick file (``benchmark/kernels/<kernel>.py``): the
calls it records and the bytes and operations it counts for them, its
seams in the program, and a new kernel taken in from its file alone."""

import importlib
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark.harness import roofline
from benchmark.harness.spec import HERE, ROOT

torch.set_num_threads(2)


class OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that ``record`` keeps
    its call."""

    @property
    def is_cuda(self):
        return True


def card(t):
    return t.as_subclass(OnCard)


def seeded_calls(seed=20261019):
    """Three calls of each kernel as the program makes them: (args, kwargs,
    out), from the seed."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*s):
        return torch.rand(*s, generator=g)

    def rois(n, h, w):
        return torch.stack([rnd(n) * w, rnd(n) * h, 2 + rnd(n) * 60, 2 + rnd(n) * 30, rnd(n) * 180 - 90], 1)

    base, meta = 0, []
    for i, (h, w) in enumerate([(32, 48), (16, 24), (8, 12)]):
        meta.append([0.25 / 2 ** i, h, w, base])
        base += h * w
    meta = torch.tensor(meta)
    calls = []
    for k in range(3):
        r = rois(17, 128, 192)
        lv = torch.randint(0, 3, (17,), generator=g, dtype=torch.int32)
        gr = torch.randint(1, 5, (17, 2), generator=g, dtype=torch.int32)
        flat = torch.zeros(base, 256, dtype=torch.bfloat16)
        grad = torch.zeros(17, 8, 32, 256, dtype=torch.bfloat16)
        images = torch.zeros(2, 64, 96, 3, dtype=torch.uint8)
        crop_rois = torch.stack([rois(9, 64, 96), rois(9, 64, 96)])
        calls.append({"k1": ((card(flat), card(meta), card(r), card(lv), card(gr), (7, 7)), {}, None),
                      "k1b": ((card(grad), card(meta), card(r), card(lv), card(gr), base),
                              {"out_dtype": torch.bfloat16} if k else {}, None),
                      "k2": ((card(images), card(crop_rois)), {"out_hw": (32, 32), "sampling_ratio": k % 2},
                             torch.zeros(2, 9, 32, 32, 3, dtype=torch.float16))})
    return calls


# (bytes, operations) of ``seeded_calls()`` as the harness recorded and
# counted them before the kernels had files of their own
PINNED = [{"k1": (667136, 11239424), "k1b": (4292608, 58720256), "k2": (130107, 663552)},
          {"k1": (627712, 12644352), "k1b": (3260416, 66060288), "k2": (124920, 442368)},
          {"k1": (624640, 7727104), "k1b": (3260416, 40370176), "k2": (132306, 638976)}]


def test_the_harness_finds_each_kernel_by_its_file():
    assert list(roofline.kernels()) == ["k1", "k1b", "k2"]
    for kernel in roofline.kernels().values():
        assert kernel.SEAMS and callable(kernel.record) and callable(kernel.is_kernel) and callable(kernel.cost)


@pytest.mark.parametrize("kind", ["k1", "k1b", "k2"])
def test_recorded_calls_count_the_bytes_and_operations_they_did(kind):
    kernel = roofline.kernels()[kind]
    for calls, pinned in zip(seeded_calls(), PINNED):
        args, kwargs, out = calls[kind]
        call = kernel.record(args, kwargs, out)
        assert tuple(kernel.cost(call)) == pinned[kind]


@pytest.mark.parametrize("kind", ["k1", "k1b", "k2"])
def test_a_call_off_the_card_is_not_recorded(kind):
    args, kwargs, out = seeded_calls()[0][kind]
    args = tuple(a.as_subclass(torch.Tensor) if isinstance(a, torch.Tensor) else a for a in args)
    assert roofline.kernels()[kind].record(args, kwargs, out) is None


@pytest.mark.parametrize("kind,name,mine", [
    ("k1", "void roi_align_rotated_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int, float const*)", True),
    ("k1b", "void (anonymous namespace)::k1b::scatter_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)", True),
    ("k1b", "void (anonymous namespace)::k1b::finish_kernel<float>(float const*, float*, int)", True),
    ("k2", "void crop_rois_kernel<unsigned char, __nv_bfloat16>(unsigned char const*, int, int)", True),
    ("k1", "void (anonymous namespace)::k1b::mark_kernel(float const*, float const*)", False),
    ("k1", "void crop_rois_kernel<unsigned char, __nv_bfloat16>(unsigned char const*, int, int)", False),
    ("k2", "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", False),
])
def test_each_kernel_knows_its_device_records(kind, name, mine):
    assert roofline.kernels()[kind].is_kernel(name) is mine


SEAMS = [(kind, where, attr) for kind, kernel in roofline.kernels().items() for where, attr in kernel.SEAMS]


@pytest.mark.parametrize("kind,where,attr", SEAMS, ids=[f"{k}:{w}.{a}" for k, w, a in SEAMS])
def test_a_kernel_seam_exists_in_the_program_and_is_callable(kind, where, attr):
    assert callable(getattr(importlib.import_module(where), attr, None)), f"{kind}: {where}.{attr}"


def test_the_recorder_wraps_every_seam_and_puts_each_back():
    before = {(w, a): getattr(importlib.import_module(w), a) for _, w, a in SEAMS}
    launches = roofline.Launches().install()
    try:
        assert set(launches.calls) == {"k1", "k1b", "k2"}
        for w, a in before:
            assert getattr(importlib.import_module(w), a) is not before[w, a]
    finally:
        launches.remove()
    assert all(getattr(importlib.import_module(w), a) is fn for (w, a), fn in before.items())


THROWAWAY = '''
"""A throwaway kernel: doubles a tensor."""

SEAMS = [("fakeprog", "double")]


def record(args, kwargs, out):
    return {"n": args[0].numel(), "elt": out.element_size()}


def is_kernel(name):
    return name.startswith("double_kernel")


def cost(call):
    return 2 * call["n"] * call["elt"], call["n"]
'''

DRIVE = '''
import torch

import fakeprog
from benchmark.harness import roofline


class Trace:
    def kernels(self, match):
        return [(n, t) for n, t in (("double_kernel<float>", 1e-8), ("other", 5.0)) if match(n)]


launches = roofline.Launches().install()
launches.on = True
fakeprog.double(torch.ones(1000))
launches.on = False
fakeprog.double(torch.ones(10))
launches.remove()
print(sorted(roofline.kernels()), launches.calls["fakeprog_double"],
      roofline.share(launches.calls["fakeprog_double"], "fakeprog_double", Trace()))
'''


def test_a_new_kernel_is_read_from_its_file_alone(tmp_path):
    """A copy of the benchmark with one file added under ``kernels/`` and
    nothing else changed: the recorder wraps the new kernel's seam, records
    its calls while on, and ``roofline.share`` reads them."""
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark" / "kernels" / "fakeprog_double.py").write_text(THROWAWAY)
    (tmp_path / "fakeprog.py").write_text("def double(x):\n    return 2 * x\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(DRIVE)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("['fakeprog_double', 'k1', 'k1b', 'k2'] [{'n': 1000, 'elt': 4}] ")
    # 8000 bytes over 3.35 TB/s in the kernel's 10 ns of device time
    assert float(line.rsplit(" ", 1)[1]) == pytest.approx(100.0 * 8000 / 3.35e12 / 1e-8)
