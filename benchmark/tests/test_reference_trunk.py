"""The reference builds the trunk its configuration names (detectron2's
``build_resnet_backbone``): depths, groups, the stride's place, res5's
dilation and the deformable 3x3 convolutions, with detectron2's names; the
shipped configurations' modules and seeded weights as they were."""

import copy
import hashlib
import itertools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import weights
from benchmark.harness.spec import load_json
from benchmark.reference import config as ref_config
from benchmark.reference.glass.models import layers as L
from benchmark.reference.glass.models.resnet import BottleneckBlock, ResNet, Trunk
from benchmark.reference.runner import GlassArch, GlassRCNN, RefRunner, build_model
from benchmark.tests.tiny import SERVE

torch.set_num_threads(2)

CONFIGS = ("glass_icdar15", "glass_pretrain")
X101 = dict(depth=101, num_groups=32, width_per_group=8, stride_in_1x1=False)


def config(name):
    return ref_config.load(load_json(f"benchmark/configs/{name}.json")["cfg"])


def digest(state_dict):
    h = hashlib.sha256()
    for k in sorted(state_dict):
        t = state_dict[k].detach().contiguous()
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


# taken on the tree before the reference read MODEL.RESNETS: the state
# dict's names and shapes, the modules' names, and each kind of seeded
# weights (CPU generator) of each shipped configuration
LAYOUT = ("07548a62728aebf57eccb247fc60d31c06e44cc776018110c6c7bed0dc71ef82",
          "c64630f08044114f8e0180e3f25a47a463de74ec78379a656d65279610d07026")
SEEDED = {("glass_icdar15", "serve"): "ee8b668697e6b94773ae37cdc8daa4d7dab5de556e599ace3a04566ef2e1e606",
          ("glass_icdar15", "train"): "211e62f6fe1f655b2e0198f9f0955f086a988c079a8483805c6e1b43859a272d",
          ("glass_pretrain", "serve"): "d056c3cde9b160696b2d418a240b18bb09534e2c63092575932c9b282af95093",
          ("glass_pretrain", "train"): "61dd3d0fb602f227fbf1bcbb8faa14183efa167ac5e50273b7b75b25981c0d12"}


@pytest.mark.parametrize("name", CONFIGS)
def test_a_shipped_configuration_builds_the_modules_it_did(name):
    model = weights._layout(config(name))
    names = "\n".join(f"{k} {tuple(v.shape)}" for k, v in model.state_dict().items())
    modules = "\n".join(n for n, _ in model.named_modules())
    assert (hashlib.sha256(names.encode()).hexdigest(), hashlib.sha256(modules.encode()).hexdigest()) == LAYOUT
    assert model.arch.trunk == Trunk()


@pytest.mark.parametrize("name,kind", sorted(SEEDED))
def test_a_shipped_configuration_seeds_the_weights_it_did(name, kind):
    cfg = config(name)
    seed = load_json(f"benchmark/configs/{name}.json")["weights_seed"]
    assert digest(weights.seeded_state_dict(cfg, seed, torch.device("cpu"), kind)) == SEEDED[name, kind]


@pytest.mark.parametrize("trunk,params", [
    (Trunk(), 23_508_032), (Trunk(depth=101), 42_500_160), (Trunk(depth=152), 58_143_808),
    (Trunk(**X101), 86_742_336)], ids=["R50", "R101", "R152", "X101-32x8d"])
def test_the_trunk_has_torchvisions_parameters_less_the_classifier(trunk, params):
    with torch.device("meta"):
        model = ResNet(trunk)
    assert sum(p.numel() for p in model.parameters()) == params


def test_the_blocks_and_widths_of_each_depth():
    for depth, blocks in ((50, (3, 4, 6, 3)), (101, (3, 4, 23, 3)), (152, (3, 8, 36, 3))):
        with torch.device("meta"):
            model = ResNet(Trunk(**{**X101, "depth": depth}))
        assert tuple(len(getattr(model, s)) for s in ("res2", "res3", "res4", "res5")) == blocks
        mids = [getattr(model, s)[0].conv2.weight.shape for s in ("res2", "res3", "res4", "res5")]
        assert mids == [(256 * 2 ** i, 8 * 2 ** i, 3, 3) for i in range(4)]  # 32 groups, 8 wide in res2
        assert model.res4[22 if depth == 101 else 0].conv2.groups == 32


SMALL = dict(stem_out_channels=8, res2_out_channels=16, num_groups=2, width_per_group=4)


@pytest.mark.parametrize("in_1x1", [True, False])
def test_the_first_block_strides_where_stride_in_1x1_says(in_1x1):
    model = ResNet(Trunk(**SMALL, stride_in_1x1=in_1x1)).eval()
    for stage in ("res3", "res4", "res5"):
        block = getattr(model, stage)[0]
        assert block.conv1.stride == ((2, 2) if in_1x1 else (1, 1))
        assert block.conv2.stride == ((1, 1) if in_1x1 else (2, 2))
        assert block.shortcut.stride == (2, 2)
        assert getattr(model, stage)[1].conv1.stride == getattr(model, stage)[1].conv2.stride == (1, 1)
    with torch.no_grad():
        feats = model(torch.randn(1, 3, 64, 96))
    assert [tuple(feats[s].shape[2:]) for s in ("res2", "res3", "res4", "res5")] == [(16, 24), (8, 12), (4, 6), (2, 3)]


def test_res5_at_dilation_2_keeps_stride_16():
    model = ResNet(Trunk(**SMALL, res5_dilation=2)).eval()
    first = model.res5[0]
    assert first.conv1.stride == first.conv2.stride == first.shortcut.stride == (1, 1)
    assert all(b.conv2.dilation == (2, 2) and b.conv2.padding == (2, 2) for b in model.res5)
    assert model.res4[0].conv2.dilation == (1, 1)
    with torch.no_grad():
        feats = model(torch.randn(1, 3, 64, 96))
    assert feats["res5"].shape[2:] == feats["res4"].shape[2:] == (4, 6)
    assert feats["res5"].shape[1] == 128


def test_the_fpn_lateral_widths_follow_the_stages():
    with torch.device("meta"):
        model = GlassRCNN(GlassArch(trunk=Trunk(**SMALL)))
    assert [getattr(model.backbone, f"fpn_lateral{i}").weight.shape[1] for i in range(2, 6)] == [16, 32, 64, 128]


@pytest.mark.parametrize("key,value", [("DEPTH", 18), ("DEPTH", 34), ("DEPTH", 77), ("RES5_DILATION", 4),
                                       ("NORM", "FrozenBN"), ("OUT_FEATURES", ["res3", "res4", "res5"])])
def test_a_value_the_reference_does_not_build_names_its_key(key, value):
    cfg = config("glass_icdar15")
    cfg.MODEL.RESNETS[key] = value
    with pytest.raises(ValueError, match=f"MODEL.RESNETS.{key}="):
        GlassArch.from_config(cfg)


def test_the_fpn_refuses_a_dilated_res5_by_its_key():
    cfg = config("glass_icdar15")
    cfg.MODEL.RESNETS.RES5_DILATION = 2
    with pytest.raises(ValueError, match="MODEL.RESNETS.RES5_DILATION="):
        weights._layout(cfg)


# -- the deformable convolution ----------------------------------------------


def deform_loop(x, offset, mask, weight, stride, dilation, groups):
    """detectron2's deformable convolution tap by tap in float64: each of
    the four bilinear corners outside the map reads 0."""
    x, offset, weight = x.double(), offset.double(), weight.double()
    n, c, h, w = x.shape
    cout, cg = weight.shape[:2]
    ho, wo = offset.shape[2:]
    g = offset.shape[1] // 18
    out = torch.zeros(n, cout, ho, wo, dtype=torch.float64)

    def at(b, ch, yy, xx):
        return float(x[b, ch, yy, xx]) if 0 <= yy < h and 0 <= xx < w else 0.0

    for b, o, i, j in itertools.product(range(n), range(cout), range(ho), range(wo)):
        acc = 0.0
        for k, (ki, kj) in enumerate(itertools.product(range(3), range(3))):
            for cc in range(cg):
                ch = (o // (cout // groups)) * cg + cc
                dg = ch // (c // g)
                y = i * stride - dilation + ki * dilation + float(offset[b, dg * 18 + 2 * k, i, j])
                xx = j * stride - dilation + kj * dilation + float(offset[b, dg * 18 + 2 * k + 1, i, j])
                y0, x0 = math.floor(y), math.floor(xx)
                ly, lx = y - y0, xx - x0
                v = ((1 - ly) * (1 - lx) * at(b, ch, y0, x0) + (1 - ly) * lx * at(b, ch, y0, x0 + 1)
                     + ly * (1 - lx) * at(b, ch, y0 + 1, x0) + ly * lx * at(b, ch, y0 + 1, x0 + 1))
                m = 1.0 if mask is None else float(mask[b, dg * 9 + k, i, j])
                acc += float(weight[o, cc, ki, kj]) * m * v
        out[b, o, i, j] = acc
    return out


def _inputs(seed, c=4, cout=6, h=7, w=6, groups=2, stride=1, dilation=1, g=2, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c, h, w, generator=gen)
    weight = torch.randn(cout, c // groups, 3, 3, generator=gen)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    offset = torch.randn(2, 18 * g, ho, wo, generator=gen) * scale
    mask = torch.rand(2, 9 * g, ho, wo, generator=gen)
    return x, offset, mask, weight


@pytest.mark.parametrize("stride,dilation,groups", [(1, 1, 1), (2, 1, 2), (1, 2, 2), (2, 2, 1)])
def test_zero_offsets_and_a_unit_mask_are_a_plain_convolution(stride, dilation, groups):
    x, offset, mask, weight = _inputs(0, groups=groups, stride=stride)
    ho, wo = (x.shape[2] - 1) // stride + 1, (x.shape[3] - 1) // stride + 1
    zero = torch.zeros(2, 36, ho, wo)
    want = F.conv2d(x, weight, None, stride, dilation, dilation, groups)
    torch.testing.assert_close(L.deform_conv2d(x, zero, None, weight, stride, dilation, groups), want)
    torch.testing.assert_close(L.deform_conv2d(x, zero, torch.ones(2, 18, ho, wo), weight, stride, dilation, groups),
                               want)


@pytest.mark.parametrize("dy,dx", [(1, 0), (0, -2), (-1, 3), (2, 2)])
def test_an_integer_offset_is_a_shifted_convolution(dy, dx):
    x, _, _, weight = _inputs(1)
    h, w = x.shape[2:]
    offset = torch.zeros(2, 36, h, w)
    offset[:, 0::2], offset[:, 1::2] = float(dy), float(dx)
    # every tap moved by (dy, dx): the plain convolution of the map padded
    # wide with zeros, read (dy, dx) further on
    full = F.conv2d(F.pad(x, (4, 4, 4, 4)), weight, None, 1, 0, 1, 2)
    want = full[:, :, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
    torch.testing.assert_close(L.deform_conv2d(x, offset, None, weight, 1, 1, 2), want)


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("stride,dilation,groups", [(1, 1, 2), (2, 1, 1), (1, 2, 2)])
def test_fractional_offsets_across_the_border_match_the_tap_loop(modulated, stride, dilation, groups):
    x, offset, mask, weight = _inputs(2, groups=groups, stride=stride, dilation=dilation, scale=2.5)
    assert (offset.abs() > 2).any()  # taps leave the 7x6 map across every border
    got = L.deform_conv2d(x, offset, mask if modulated else None, weight, stride, dilation, groups)
    want = deform_loop(x, offset, mask if modulated else None, weight, stride, dilation, groups)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("modulated", [False, True])
def test_the_deformable_block_reads_offsets_and_mask_as_detectron2(modulated):
    torch.manual_seed(3)
    block = BottleneckBlock(16, 8, 32, 2, 2, False, 1, (modulated, 2)).eval()
    assert block.conv2_offset.weight.shape == ((54 if modulated else 36), 8, 3, 3)
    assert block.conv2_offset.bias is not None and block.conv2.weight.shape == (8, 4, 3, 3)
    assert block.conv2_offset.stride == (2, 2) and block.conv2.stride == 2
    x = torch.randn(1, 16, 9, 8)
    with torch.no_grad():
        out = block.conv1(x)
        om = block.conv2_offset(out)
        offset, mask = (om[:, :36], torch.sigmoid(om[:, 36:])) if modulated else (om, None)
        mid = L.relu(block.conv2.norm(L.deform_conv2d(out, offset, mask, block.conv2.weight, 2, 1, 2)))
        want = L.relu(block.conv3(mid) + block.shortcut(x))
        torch.testing.assert_close(block(x), want)


# -- a deeper trunk from a configuration alone ---------------------------------


def tiny_config(modulated=False, **resnets):
    """glass_icdar15 with an X101-style trunk cut to a tiny width:
    DEPTH 101, grouped 3x3 convolutions, the stride in them, deformable
    res3-res5."""
    cfg = copy.deepcopy(load_json("benchmark/configs/glass_icdar15.json")["cfg"])
    cfg["MODEL"]["RESNETS"].update(DEPTH=101, NUM_GROUPS=4, WIDTH_PER_GROUP=2, STRIDE_IN_1X1=False,
                                   STEM_OUT_CHANNELS=8, RES2_OUT_CHANNELS=16,
                                   DEFORM_ON_PER_STAGE=[False, True, True, True], DEFORM_MODULATED=modulated,
                                   DEFORM_NUM_GROUPS=2, **resnets)
    cfg["MODEL"]["PIXEL_STD"] = [57.375, 57.120, 58.395]
    return ref_config.load(cfg, SERVE)


def test_detectron2_names_for_a_deeper_deformable_trunk():
    sd = weights._layout(tiny_config()).state_dict()
    for name in ("backbone.bottom_up.res4.22.conv2.weight", "backbone.bottom_up.res3.0.conv2_offset.weight",
                 "backbone.bottom_up.res3.0.conv2_offset.bias", "backbone.bottom_up.res5.2.conv2.norm.running_var"):
        assert name in sd
    assert "backbone.bottom_up.res2.0.conv2_offset.weight" not in sd
    assert sd["backbone.bottom_up.res3.0.conv2_offset.weight"].shape == (36, 16, 3, 3)
    assert sd["backbone.fpn_lateral5.weight"].shape == (256, 128, 1, 1)


def test_train_weights_zero_the_offsets_and_serve_weights_draw_them():
    cfg = tiny_config()
    train = weights.seeded_state_dict(cfg, 7, torch.device("cpu"), "train")
    serve = weights.seeded_state_dict(cfg, 7, torch.device("cpu"), "serve")
    offsets = [k for k in train if ".conv2_offset." in k]
    assert len(offsets) == 2 * (4 + 23 + 3)
    assert all(not train[k].any() for k in offsets)
    w = serve["backbone.bottom_up.res4.5.conv2_offset.weight"]
    std = math.sqrt(2.0 / (32 * 9))  # N(0, 2/fan_in): res4's bottleneck is 32 wide, 3x3 taps
    assert abs(float(w.std()) - std) < 0.1 * std
    assert not serve["backbone.bottom_up.res4.5.conv2_offset.bias"].any()
    # a block's last norm is scaled as the plain blocks' are
    assert float(serve["backbone.bottom_up.res3.1.conv3.norm.weight"].mean()) == pytest.approx(0.25, abs=0.05)


@pytest.mark.parametrize("modulated", [False, True])
def test_a_deeper_deformable_glass_runs_through_the_reference(modulated):
    """Built, seeded, calibrated and run from a configuration alone, with
    no harness file edited."""
    cfg = tiny_config(modulated)
    dev = torch.device("cpu")
    image = np.random.RandomState(0).randint(0, 255, (48, 160, 3)).astype(np.uint8)
    sd = weights.seeded_state_dict(cfg, 11, dev, "serve")
    with torch.no_grad():
        sd = weights.calibrate(RefRunner(cfg, build_model(cfg, sd, dev), dev), image)
        rr = RefRunner(cfg, build_model(cfg, sd, dev), dev)
        feats = rr.model.backbone(torch.zeros(1, 3, 64, 224))
        resized, _ = rr.eval_resize(image)
        out = rr.run_model(resized)
    assert sd["backbone.bottom_up.res4.22.conv2.norm.running_var"].gt(0).all()
    assert [tuple(feats[f"p{i}"].shape) for i in range(2, 7)] == [
        (1, 256, 16, 56), (1, 256, 8, 28), (1, 256, 4, 14), (1, 256, 2, 7), (1, 256, 1, 4)]
    assert all(torch.isfinite(v).all() for v in out.values() if isinstance(v, torch.Tensor) and v.is_floating_point())
