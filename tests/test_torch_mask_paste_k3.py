"""K3 (``ops/paste_masks_rotated.py``) and the paster around it
(``postprocess/paste.py::RotatedMaskPaster``): the word table equals the
per-word loop's windows and maps, the plain version's windows equal
``cv2.warpAffine(...) >= 0.5`` bit for bit, the knife-edge flags cover
every straddling word, and the paster's polygons equal the loop's.

The card test runs without this directory's conftest (which loads jax):
``python3 -m pytest tests/test_torch_mask_paste_k3.py -m cuda --noconftest
-p no:cacheprovider`` on a machine with a GPU."""

from fractions import Fraction

import cv2
import numpy as np
import pytest
import torch

from glass_tpu_torch.ops import _cuda
from glass_tpu_torch.ops import paste_masks_rotated as k3
from glass_tpu_torch.postprocess import detector_postprocess, paste
from glass_tpu_torch.structures import Instances
from glass_tpu_torch.utils import trace

SHAPE = (96, 160)


def loop_word(box, shape, mask_shape=(28, 28)):
    """The loop's window and forward map of one word
    (``rotated_masks_to_polygons``'s own lines)."""
    img_h, img_w = shape
    mh, mw = mask_shape
    cx, cy, w, h, a = box
    t = np.deg2rad(a)
    cos_t, sin_t = np.cos(t), np.sin(t)

    def corner(dx, dy):
        return [cx + dx * cos_t + dy * sin_t, cy - dx * sin_t + dy * cos_t]

    corners = np.array([corner(-w / 2, -h / 2), corner(w / 2, -h / 2),
                        corner(-w / 2, h / 2), corner(w / 2, h / 2)], np.float32)
    x0 = max(int(np.floor(corners[:, 0].min())) - 2, 0)
    y0 = max(int(np.floor(corners[:, 1].min())) - 2, 0)
    x1 = min(int(np.ceil(corners[:, 0].max())) + 2, img_w)
    y1 = min(int(np.ceil(corners[:, 1].max())) + 2, img_h)
    dst = np.float32([corner(-w / 2, -h / 2), corner(w / 2, -h / 2), corner(-w / 2, h / 2)]) \
        - np.float32([[x0, y0]])
    mat = cv2.getAffineTransform(np.float32([[0, 0], [mw, 0], [0, mh]]), dst)
    return (x0, y0, x1, y1), mat


def masks_for(rng, n, tie_share=0.05):
    """fp16 probabilities around 0.5, as a mask head's, some taps exactly
    0.5."""
    logits = rng.normal(0, 0.8, (n, 28, 28)) + rng.normal(0, 1.0, (n, 1, 1))
    m = (1 / (1 + np.exp(-logits))).astype(np.float16)
    m[rng.random(m.shape) < tie_share] = 0.5
    return m


def boxes_for(case, rng, n=10, shape=SHAPE):
    img_h, img_w = shape
    b = np.zeros((n, 5), np.float32)
    b[:, 0] = rng.uniform(0, img_w, n)
    b[:, 1] = rng.uniform(0, img_h, n)
    b[:, 2] = rng.uniform(8, 70, n)
    b[:, 3] = rng.uniform(4, 30, n)
    b[:, 4] = rng.uniform(-180, 180, n)
    if case == "edges":  # centres on and past every edge of the image
        b[:, 0] = np.resize([-5, 0, img_w / 2, img_w, img_w + 5], n)
        b[:, 1] = np.resize([img_h / 2, -3, img_h + 3, 0, img_h], n)
    elif case == "larger_than_frame":
        b[:, 2] = rng.uniform(img_w, 3 * img_w, n)
        b[:, 3] = rng.uniform(img_h, 2 * img_h, n)
    elif case == "angles":
        b[:, 4] = np.resize([0, 45, -45, 90, -90, 180], n)
    elif case == "sub_pixel":
        b[:, 2] = np.resize([0.3, 0.9, 25.0, 0.05], n)
        b[:, 3] = np.resize([12.0, 0.5, 0.2, 0.7], n)
    elif case == "empty":  # windows clipped to nothing
        b[:, 0] = np.resize([-200, img_w + 200, 50], n)
        b[:, 1] = np.resize([40, -300, img_h + 300], n)
    return b


CASES = ("random", "edges", "larger_than_frame", "angles", "sub_pixel", "empty")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_word_table_equals_the_loop(case, dtype):
    rng = np.random.default_rng(CASES.index(case))
    boxes = boxes_for(case, rng, 24).astype(dtype)
    win, fwd, inv = paste.word_windows(boxes, SHAPE, (28, 28))
    for i in range(len(boxes)):
        window, mat = loop_word(boxes[i], SHAPE)
        assert tuple(win[i]) == window, i
        assert np.array_equal(fwd[i], mat.ravel()), i
        if window[2] > window[0] and window[3] > window[1]:
            assert np.array_equal(inv[i], cv2.invertAffineTransform(mat).ravel()), i


def test_host_form_is_the_only_match():
    """This host's cv2 warps in exactly one of K3's forms (OpenCV 5 in the
    float form, OpenCV 4 in the fixed one)."""
    form = paste.host_form()
    assert form is not None
    masks, boxes, shape = paste._probe_words()
    win, fwd, inv = paste.word_windows(boxes, shape, (28, 28))
    other = k3.FORM_FIXED if form == k3.FORM_FLOAT else k3.FORM_FLOAT
    differ = 0
    for m, f, d, (x0, y0, x1, y1) in zip(masks, fwd, inv, win):
        ref = cv2.warpAffine(m, f.reshape(2, 3), (int(x1 - x0), int(y1 - y0)), flags=cv2.INTER_LINEAR)
        differ += int((k3.warp_window_plain(torch.from_numpy(m), d, ref.shape[1], ref.shape[0], other)
                       != torch.from_numpy(ref)).sum())
    assert differ > 0


def _twin_and_cv2(case, seed, form, eps=0.0, n=10):
    rng = np.random.default_rng(seed)
    boxes = boxes_for(case, rng, n)
    masks = masks_for(rng, n)
    win, fwd, inv = paste.word_windows(boxes, SHAPE, (28, 28))
    keep = (win[:, 2] > win[:, 0]) & (win[:, 3] > win[:, 1])
    w, h = (win[keep, 2] - win[keep, 0]), (win[keep, 3] - win[keep, 1])
    sizes = (w * h + 15) // 16 * 16
    geo = torch.from_numpy(np.stack([np.cumsum(sizes) - sizes, w, h], 1))
    out, flags, _ = k3.paste_binarize_plain(torch.from_numpy(masks[keep].astype(np.float32)),
                                            torch.from_numpy(inv[keep]), geo, form, 0.5, eps)
    refs = [cv2.warpAffine(m.astype(np.float32), f.reshape(2, 3), (int(ww), int(hh)),
                           flags=cv2.INTER_LINEAR)
            for m, f, ww, hh in zip(masks[keep], fwd[keep], w, h)]
    values = [k3.warp_window_plain(torch.from_numpy(m.astype(np.float32)), d, int(ww), int(hh), form)
              for m, d, ww, hh in zip(masks[keep], inv[keep], w, h)]
    return out, flags, geo, refs, values, int((~keep).sum())


def _words(case, seed, n=10):
    """The masks (float32) and inverse maps of ``_twin_and_cv2``'s kept
    words."""
    rng = np.random.default_rng(seed)
    boxes = boxes_for(case, rng, n)
    masks = masks_for(rng, n)
    win, _, inv = paste.word_windows(boxes, SHAPE, (28, 28))
    keep = (win[:, 2] > win[:, 0]) & (win[:, 3] > win[:, 1])
    return [torch.from_numpy(m.astype(np.float32)) for m in masks[keep]], inv[keep]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_twin_equals_cv2_bit_for_bit(case, seed):
    out, flags, geo, refs, values, empty = _twin_and_cv2(case, seed, paste.host_form())
    if case == "empty":
        assert empty > 0
    for (off, w, h), ref, v in zip(geo.tolist(), refs, values):
        assert torch.equal(v, torch.from_numpy(ref))
        assert np.array_equal(out[off:off + w * h].numpy().reshape(h, w), (ref >= 0.5).astype(np.uint8))
        assert not out[off + w * h:(off + w * h + 15) // 16 * 16].any()


def test_exact_half_taps_binarize_as_cv2():
    """A mask of exact fp16 0.5 everywhere: every inside pixel is a tie."""
    masks = np.full((3, 28, 28), 0.5, np.float16)
    boxes = np.float32([[50, 40, 28, 28, 0], [80, 50, 40, 10, 90], [30, 30, 56, 14, -45]])
    win, fwd, inv = paste.word_windows(boxes, SHAPE, (28, 28))
    form = paste.host_form()
    for m, f, d, (x0, y0, x1, y1) in zip(masks, fwd, inv, win):
        ref = cv2.warpAffine(m.astype(np.float32), f.reshape(2, 3), (int(x1 - x0), int(y1 - y0)),
                             flags=cv2.INTER_LINEAR)
        v = k3.warp_window_plain(torch.from_numpy(m.astype(np.float32)), d, ref.shape[1], ref.shape[0], form)
        assert torch.equal(v, torch.from_numpy(ref))
        assert (ref == 0.5).sum() > 0


@pytest.mark.parametrize("case", ("random", "angles", "larger_than_frame"))
def test_flags_cover_every_straddling_word(case):
    """The float form's values held against values with a gap (cv2's where
    this host warps in the fixed form, else the fixed form's), at 4x the
    widest gap: every word with a pixel on the other side of the threshold
    is flagged.  With the host's form and no margin no pixel straddles
    cv2's, and the flags are the words with a tie (in the fixed form a tie
    whose value was rounded)."""
    form = paste.host_form()
    out, flags, geo, refs, values, _ = _twin_and_cv2(case, 7, k3.FORM_FLOAT)
    masks, maps = _words(case, 7)
    if form == k3.FORM_FLOAT:
        refs = [k3.warp_window_plain(m, d, w, h, k3.FORM_FIXED).numpy()
                for m, d, (_, w, h) in zip(masks, maps, geo.tolist())]
    gap = max(float((v.double() - torch.from_numpy(r).double()).abs().max()) for r, v in zip(refs, values))
    assert 0 < gap < 0.1
    out, flags, geo, _, values, _ = _twin_and_cv2(case, 7, k3.FORM_FLOAT, eps=4 * gap)
    straddle = [bool(((v >= 0.5) != torch.from_numpy(r >= 0.5)).any()) for v, r in zip(values, refs)]
    assert any(straddle)
    assert all(f for f, s in zip(flags.tolist(), straddle) if s)
    out, flags, geo, refs, values, _ = _twin_and_cv2(case, 7, form)
    assert not any(bool(((v >= 0.5) != torch.from_numpy(r >= 0.5)).any()) for v, r in zip(values, refs))
    rounded = [torch.ones_like(v, dtype=torch.bool) for v in values]
    if form == k3.FORM_FIXED:
        rounded = [~k3.warp_window_plain(m, d, w, h, form, with_exact=True)[1]
                   for m, d, (_, w, h) in zip(masks, maps, geo.tolist())]
    assert flags.tolist() == [int(bool(((v == 0.5) & r).any())) for v, r in zip(values, rounded)]


def test_fixed_form_ties_of_exact_values_are_not_flagged():
    """In the fixed form a pixel that samples a tap of exactly 0.5 at a
    whole-pixel offset reads 0.5 with no rounding: not flagged.  A tie
    that took rounding is."""
    mask = torch.full((28, 28), 0.5)
    v, exact = k3.warp_window_plain(mask, [1.0, 0.0, 0.0, 0.0, 1.0, 0.0], 20, 20, k3.FORM_FIXED,
                                    with_exact=True)
    assert bool((v == 0.5).all()) and bool(exact.all())
    geo = torch.tensor([[0, 20, 20]])
    _, flags, fg = k3.paste_binarize_plain(mask[None], torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]],
                                                                    dtype=torch.float64), geo, k3.FORM_FIXED)
    assert flags.tolist() == [0] and fg.tolist() == [[0, 0, 19, 19]]
    third = torch.full((28, 28), np.float32(1 / 3))
    v, exact = k3.warp_window_plain(third, [1.0, 0.0, 0.3, 0.0, 1.0, 0.7], 20, 20, k3.FORM_FIXED,
                                    with_exact=True)
    assert not bool(exact.all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contours_of_the_foreground_box_are_the_windows(seed):
    """findContours over the foreground's bounding box (a strided view),
    shifted, gives the whole window's contours in the same order."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        img = (rng.random((h, w)) < rng.uniform(0.02, 0.3)).astype(np.uint8)
        img[rng.integers(0, h):, :rng.integers(0, w)] = rng.integers(0, 2)
        ys, xs = np.nonzero(img)
        if not len(ys):
            continue
        want, _ = cv2.findContours(img, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        crop = img[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
        got, _ = cv2.findContours(crop, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a + np.array([xs.min(), ys.min()]), b)


def _exact_nearest(x: Fraction) -> np.float32:
    r = np.float32(float(x))
    for c in (np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))):
        d, dc = abs(Fraction(float(r)) - x), abs(Fraction(float(c)) - x)
        if dc < d or (dc == d and int(np.float32(c).view(np.int32)) % 2 == 0):
            r = c
    return r


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, 3000).astype(np.float32)
    b = rng.normal(0, 1, 3000).astype(np.float32)
    c = rng.normal(0, 1, 3000).astype(np.float32)
    # float32 midpoints reached only after a second rounding: c one half-ulp
    # off a float32, a * b a tiny part of it
    c[:500] = (np.float32(1) + np.arange(500, dtype=np.float32) * np.float32(2 ** -20))
    a[:500] = np.float32(2 ** -24)
    b[:500] = np.float32(1) + np.float32(2 ** -23) * rng.integers(1, 100, 500).astype(np.float32)
    got = k3.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        assert g == _exact_nearest(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))


def test_tile_table():
    geo = np.array([[0, 70, 100], [7008, 3, 5], [7024, 64, 64]])
    t = k3.tile_table(geo)
    assert t.tolist() == [[0, 0], [0, 4096], [1, 0], [2, 0]]


def _same_polygons(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert (p is None) == (q is None)
        if p is not None:
            assert np.array_equal(p, q)


@pytest.mark.parametrize("variant", ("one_launch", "many_launches", "all_flagged", "host_reach",
                                     "float32_masks"))
def test_paster_polygons_equal_the_loop(variant, monkeypatch):
    """The paster's whole host flow (word table, launches, flags, contours
    over the output buffer), with K3's plain version standing in for the
    card."""
    rng = np.random.default_rng(11)
    shape = (180, 320)
    boxes = np.concatenate([boxes_for(c, rng, 6, shape) for c in CASES])
    masks = masks_for(rng, len(boxes))
    if variant == "float32_masks":
        masks = masks.astype(np.float32) / np.float32(1.01)
    if variant == "many_launches":
        monkeypatch.setattr(paste, "LAUNCH_BYTES", 4096)
    if variant == "all_flagged":
        monkeypatch.setattr(paste, "KNIFE_EDGE", 1.0)
    if variant == "host_reach":
        monkeypatch.setattr(paste, "COORD_LIMIT", 60.0)
    want = paste.rotated_masks_to_polygons(masks, boxes, shape)
    assert sum(p is not None for p in want) > 10
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.reset()
        got = paste.RotatedMaskPaster("cpu")(masks, boxes, shape)
        counts = trace.totals()
    _same_polygons(got, want)
    device = counts.get("glass.post.polygons.device_words", 0)
    fallback = counts.get("glass.post.polygons.fallback_words", 0)
    if variant == "all_flagged":
        assert fallback > 0
    elif variant == "host_reach":
        assert fallback > 0
    else:
        assert device > 0


def test_detector_postprocess_with_the_paster():
    rng = np.random.default_rng(5)
    boxes = boxes_for("random", rng, 12, (200, 300))
    masks = masks_for(rng, 12)
    inst = Instances((200, 300), pred_boxes=boxes, pred_rboxes=boxes.copy(), pred_masks=masks,
                     scores=np.linspace(0.9, 0.5, 12, dtype=np.float32))
    a = detector_postprocess(inst, 400, 600)
    b = detector_postprocess(inst, 400, 600, paster=paste.RotatedMaskPaster("cpu"))
    _same_polygons(b.pred_mask_polygons, a.pred_mask_polygons)
    assert not b.has("pred_masks")


@pytest.mark.cuda
@pytest.mark.parametrize("form", (k3.FORM_FLOAT, k3.FORM_FIXED))
def test_k3_equals_its_plain_version_on_the_card(form):
    if not torch.cuda.is_available():
        pytest.skip("K3 runs only on an NVIDIA GPU")
    rng = np.random.default_rng(21 + form)
    shape = (360, 640)
    boxes = np.concatenate([boxes_for(c, rng, 8, shape) for c in CASES])
    boxes[:8, 2:4] *= 6  # some large words
    masks = masks_for(rng, len(boxes)).astype(np.float32)
    win, fwd, inv = paste.word_windows(boxes, shape, (28, 28))
    keep = (win[:, 2] > win[:, 0]) & (win[:, 3] > win[:, 1])
    w, h = win[keep, 2] - win[keep, 0], win[keep, 3] - win[keep, 1]
    sizes = (w * h + 15) // 16 * 16
    geo = np.stack([np.cumsum(sizes) - sizes, w, h], 1)
    n = int(keep.sum())
    want, want_flags, want_fg = k3.paste_binarize_plain(torch.from_numpy(masks[keep]),
                                                        torch.from_numpy(inv[keep]),
                                                        torch.from_numpy(geo), form, 0.5, 1e-3)
    out = torch.full((int(sizes.sum()) + 64,), 7, dtype=torch.uint8, pin_memory=True)
    flags = torch.zeros(n, dtype=torch.int32, pin_memory=True)
    fg = torch.tensor([[k3.NO_FG, k3.NO_FG, -1, -1]] * n, dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    before = _cuda.LAUNCHES[k3.KERNEL]
    k3.paste_binarize(torch.from_numpy(masks[keep]).cuda(), torch.from_numpy(inv[keep]).cuda(),
                      torch.from_numpy(geo).cuda(), torch.from_numpy(k3.tile_table(geo)).cuda(), fg,
                      form, 0.5, 1e-3, out, flags, stream)
    stream.synchronize()
    assert _cuda.LAUNCHES[k3.KERNEL] == before + 1
    assert torch.equal(out[:len(want)], want)
    assert (out[int(sizes.sum()):] == 7).all()
    assert torch.equal(flags, want_flags) and want_flags.any()
    assert torch.equal(fg.cpu(), want_fg) and (want_fg[:, 2] < 0).any() and (want_fg[:, 2] >= 0).any()
    if paste.host_form() is not None:
        _same_polygons(paste.RotatedMaskPaster("cuda")(masks, boxes, shape),
                       paste.rotated_masks_to_polygons(masks, boxes, shape))


def test_paster_slots_under_concurrent_threads():
    """Threads post-processing at once (TPU.POSTPROCESS_WORKERS) each take
    a slot of the paster's own: more threads than cores, a short switch
    interval, every result still the loop's."""
    import sys
    import threading

    rng = np.random.default_rng(13)
    shape = (48, 64)
    sets = []
    for _ in range(4):
        boxes = boxes_for("random", rng, 3, shape)
        boxes[:, 2:4] = np.minimum(boxes[:, 2:4], 20)
        sets.append((masks_for(rng, 3), boxes))
    want = [paste.rotated_masks_to_polygons(m, b, shape) for m, b in sets]
    paster = paste.RotatedMaskPaster("cpu")
    results, errors = {}, []

    def work(k):
        try:
            for r in range(2):
                results[k, r] = paster(*sets[(k + r) % len(sets)], shape)
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert len(results) == 24
    for (k, r), got in results.items():
        _same_polygons(got, want[(k + r) % len(sets)])
    assert 1 <= len(paster._free) <= 12
