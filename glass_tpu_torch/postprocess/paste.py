"""Rotated mask pasting and mask polygons.

Port of reference ``post_processor_academic.py:187-335``: paste each
predicted 28x28 mask into the full image through a rotated bilinear sampling
grid (the reference loops ``grid_sample`` per instance on GPU; here the
grid inversion is vectorized per instance on the host).

``rotated_masks_to_polygons`` warps and thresholds each word's window with
cv2 on the host, word by word.  ``RotatedMaskPaster`` gives the same
polygons with the warp and threshold of every word of an image in one
launch of kernel K3 (``ops/paste_masks_rotated.py``): the host builds the
word table at once (``word_windows``), the kernel writes the binary windows
into pinned host memory, and one call of the native contour tracer
(``native/contours.cpp``) follows every word's largest contour in place,
outside the interpreter lock.  ``native_contours`` admits the tracer only
where it equals this host's cv2 on a fixed set of windows."""

from __future__ import annotations

import functools
import threading

import cv2
import numpy as np
import torch

from ..native import load_contours
from ..ops import paste_masks_rotated as k3
from ..utils import trace

# K3 flags a word with a pixel this close to the threshold, and the host
# warps such a word again with cv2.  Both forms of K3 equal the host's cv2
# bit for bit (tests/test_torch_mask_paste_k3.py), so only ties are
# flagged, and in the fixed form only ties whose value took rounding: there
# one pixel in 1024 samples a tap exactly and a tap of 0.5 reads 0.5 with
# no rounding, the same in any implementation of the form; flagging those
# too sent about 30 % of a serving image's words, the largest, to cv2.
KNIFE_EDGE = 0.0
# A word whose sample coordinates reach this far from its mask, or whose
# map is not finite, is warped on the host (the kernel's integer
# coordinates hold this range exactly in both forms).
COORD_LIMIT = 2.0 ** 20
# The pinned output a launch writes, at most: an image with larger windows
# takes more than one launch (a window larger than this one of its own).
LAUNCH_BYTES = 64 << 20


def paste_masks_rotated(
    masks: np.ndarray,
    boxes: np.ndarray,
    image_shape,
    threshold: float = 0.5,
) -> np.ndarray:
    """masks (N, M, M) probabilities, boxes (N, 4|5) -> (N, H, W) bool."""
    img_h, img_w = image_shape
    n = len(masks)
    out = np.zeros((n, img_h, img_w), bool)
    for i in range(n):
        box = boxes[i]
        m = masks[i].astype(np.float32)
        mh, mw = m.shape
        if box.shape[-1] == 5:
            cx, cy, w, h, a = box
            # Affine map from mask pixel coords to image coords.
            t = np.deg2rad(a)
            cos_t, sin_t = np.cos(t), np.sin(t)
            # Affine map: mask (0..mw, 0..mh) spans the box extent (w, h)
            # rotated by angle a (CCW in image coords, y down).
            src_tri = np.float32([[0, 0], [mw, 0], [0, mh]])
            # Corners of the rotated box (top-left, top-right, bottom-left)
            # consistent with boxes_to_polygons' vertex order.
            def corner(dx, dy):
                # dx, dy in box frame, y down; rotate by angle a CCW (image coords)
                x = cx + dx * cos_t + dy * sin_t
                y = cy - dx * sin_t + dy * cos_t
                return [x, y]

            dst_tri = np.float32(
                [corner(-w / 2, -h / 2), corner(w / 2, -h / 2), corner(-w / 2, h / 2)]
            )
            mat = cv2.getAffineTransform(src_tri, dst_tri)
            pasted = cv2.warpAffine(m, mat, (img_w, img_h), flags=cv2.INTER_LINEAR)
        else:
            x0, y0, x1, y1 = box
            bw = max(int(round(x1 - x0)), 1)
            bh = max(int(round(y1 - y0)), 1)
            resized = cv2.resize(m, (bw, bh), interpolation=cv2.INTER_LINEAR)
            pasted = np.zeros((img_h, img_w), np.float32)
            ix0, iy0 = max(int(x0), 0), max(int(y0), 0)
            ix1, iy1 = min(int(x0) + bw, img_w), min(int(y0) + bh, img_h)
            pasted[iy0:iy1, ix0:ix1] = resized[: iy1 - iy0, : ix1 - ix0]
        out[i] = pasted >= threshold
    return out


def _largest_contour(binary: np.ndarray, x0: int, y0: int):
    """The largest external contour of a uint8 window, in image
    coordinates, as (K, 2) float64; None for none or fewer than 3 points."""
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    largest = max(contours, key=cv2.contourArea)
    poly = largest.reshape(-1, 2).astype(np.float64)
    if len(poly) < 3:
        return None
    poly += np.array([x0, y0], np.float64)
    return poly


def rotated_masks_to_polygons(
    masks: np.ndarray,
    boxes: np.ndarray,
    image_shape,
    threshold: float = 0.5,
):
    """masks (N, M, M) probs + boxes (N, 5) -> list of (K, 2) float64
    polygons in image coords (largest contour; None where empty).

    Numerically identical to pasting each mask to full resolution and
    taking the largest contour (reference text_evaluator.masks_to_polygons
    over academic ``paste_masks_in_image``): a mask is exactly zero outside
    its rotated box, so the warp + contour runs only inside the box's AABB
    window (+2 px of bilinear support), ~100x less host work per image
    than the full-resolution paste on large frames.
    """
    img_h, img_w = image_shape
    polys = []
    for i in range(len(masks)):
        cx, cy, w, h, a = boxes[i]
        m = masks[i].astype(np.float32)
        mh, mw = m.shape
        t = np.deg2rad(a)
        cos_t, sin_t = np.cos(t), np.sin(t)

        def corner(dx, dy):
            return [cx + dx * cos_t + dy * sin_t, cy - dx * sin_t + dy * cos_t]

        corners = np.array(
            [corner(-w / 2, -h / 2), corner(w / 2, -h / 2),
             corner(-w / 2, h / 2), corner(w / 2, h / 2)], np.float32
        )
        x0 = max(int(np.floor(corners[:, 0].min())) - 2, 0)
        y0 = max(int(np.floor(corners[:, 1].min())) - 2, 0)
        x1 = min(int(np.ceil(corners[:, 0].max())) + 2, img_w)
        y1 = min(int(np.ceil(corners[:, 1].max())) + 2, img_h)
        if x1 <= x0 or y1 <= y0:
            polys.append(None)
            continue
        src_tri = np.float32([[0, 0], [mw, 0], [0, mh]])
        dst_tri = np.float32(
            [corner(-w / 2, -h / 2), corner(w / 2, -h / 2), corner(-w / 2, h / 2)]
        ) - np.float32([[x0, y0]])
        mat = cv2.getAffineTransform(src_tri, dst_tri)
        window = cv2.warpAffine(m, mat, (x1 - x0, y1 - y0), flags=cv2.INTER_LINEAR)
        binary = (window >= threshold).astype(np.uint8)
        polys.append(_largest_contour(binary, x0, y0))
    return polys


def word_windows(boxes: np.ndarray, image_shape, mask_shape):
    """Every word's window and maps at once, bit for bit what
    ``rotated_masks_to_polygons`` computes word by word: (N, 4) int64
    windows ``(x0, y0, x1, y1)`` (empty where ``x1 <= x0`` or ``y1 <=
    y0``), the (N, 6) float64 forward map ``cv2.getAffineTransform`` solves
    from the mask's corners to the window's, and the (N, 6) float64 inverse
    that ``cv2.warpAffine`` computes from it.  The corners are taken in the
    boxes' dtype and rounded to float32, as the loop does."""
    img_h, img_w = image_shape
    mh, mw = mask_shape
    cx, cy, w, h, a = np.asarray(boxes).T
    t = np.deg2rad(a)
    cos_t, sin_t = np.cos(t), np.sin(t)
    hw, hh = w / 2, h / 2
    corners = np.stack(
        [np.stack([cx + dx * cos_t + dy * sin_t, cy - dx * sin_t + dy * cos_t], -1)
         for dx, dy in ((-hw, -hh), (hw, -hh), (-hw, hh), (hw, hh))], 1
    ).astype(np.float32)
    x0 = np.maximum(np.floor(corners[..., 0].min(1)).astype(np.int64) - 2, 0)
    y0 = np.maximum(np.floor(corners[..., 1].min(1)).astype(np.int64) - 2, 0)
    x1 = np.minimum(np.ceil(corners[..., 0].max(1)).astype(np.int64) + 2, img_w)
    y1 = np.minimum(np.ceil(corners[..., 1].max(1)).astype(np.int64) + 2, img_h)
    dst = (corners[:, :3] - np.stack([x0, y0], -1).astype(np.float32)[:, None]).astype(np.float64)
    # getAffineTransform's LU solve of the three corner pairs, whose source
    # corners are (0, 0), (mw, 0) and (0, mh), reduces to these divisions.
    (ax, ay), (bx, by), (qx, qy) = dst[:, 0].T, dst[:, 1].T, dst[:, 2].T
    f0, f1, f2 = (bx - ax) / mw, (qx - ax) / mh, ax
    f3, f4, f5 = (by - ay) / mw, (qy - ay) / mh, ay
    # warpAffine's inversion of the forward map, operation for operation.
    det = f0 * f4 - f1 * f3
    with np.errstate(divide="ignore"):
        det = np.where(det != 0, 1.0 / np.where(det != 0, det, 1.0), 0.0)
    i0, i4, i1, i3 = f4 * det, f0 * det, f1 * -det, f3 * -det
    i2 = -i0 * f2 - i1 * f5
    i5 = -i3 * f2 - i4 * f5
    return (np.stack([x0, y0, x1, y1], 1), np.stack([f0, f1, f2, f3, f4, f5], 1),
            np.stack([i0, i1, i2, i3, i4, i5], 1))


def _probe_words():
    """A fixed set of words whose windows tell K3's forms apart: rotated
    and scaled, with windows of every width mod 16."""
    rng = np.random.default_rng(20260)
    n = 8
    boxes = np.stack([rng.uniform(40, 120, n), rng.uniform(30, 60, n), rng.uniform(20, 70, n),
                      rng.uniform(6, 30, n), np.array([0, 90, -45, 180, 33.3, -71.7, 128.9, 7.5])],
                     1).astype(np.float32)
    masks = rng.random((n, 28, 28)).astype(np.float16).astype(np.float32)
    return masks, boxes, (90, 160)


@functools.lru_cache(maxsize=None)
def host_form():
    """The form of K3 whose windows equal this host's ``cv2.warpAffine``
    bit for bit on the probe words, or None: then the host warps every
    word.  OpenCV 5 warps float32 in ``FORM_FLOAT``, OpenCV 4 in
    ``FORM_FIXED``."""
    masks, boxes, shape = _probe_words()
    win, fwd, inv = word_windows(boxes, shape, masks.shape[1:])
    want = [cv2.warpAffine(m, f.reshape(2, 3), (int(x1 - x0), int(y1 - y0)), flags=cv2.INTER_LINEAR)
            for m, f, (x0, y0, x1, y1) in zip(masks, fwd, win)]
    for form in (k3.FORM_FLOAT, k3.FORM_FIXED):
        got = [k3.warp_window_plain(torch.from_numpy(m), d, ref.shape[1], ref.shape[0], form)
               for m, d, ref in zip(masks, inv, want)]
        if all(torch.equal(g, torch.from_numpy(ref)) for g, ref in zip(got, want)):
            return form
    return None


def _probe_windows():
    """A fixed set of binary windows on which a contour tracer that is not
    cv2's, point for point, shows it: seeded noise at several thresholds
    and smoothness, a ring with components nested in its hole, lines one
    pixel wide (straight and diagonal), single pixels, full and empty
    windows, components on every edge, and ties of equal areas."""
    rng = np.random.default_rng(20261)
    wins = []
    for thr in (0.1, 0.3, 0.5, 0.7, 0.9):
        for h, w in ((1, 1), (1, 13), (9, 1), (7, 9), (33, 17), (40, 71)):
            wins.append(rng.random((h, w)) >= thr)
            small = rng.random((6, 7)).astype(np.float32)
            wins.append(cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR) >= thr)
    ring = np.zeros((24, 30), bool)
    ring[2:22, 2:28] = True
    ring[5:19, 5:25] = False
    ring[8:16, 8:14] = True  # a component in the hole, itself with a hole
    ring[10:14, 10:12] = False
    ring[11, 11] = True
    ring[9:11, 17:22] = True
    wins.append(ring)
    lines = np.zeros((16, 16), bool)
    lines[2, 1:9] = lines[4:12, 12] = True
    lines[np.arange(5, 15), np.arange(0, 10)] = True
    lines[np.arange(14, 8, -1), np.arange(9, 15)] = True
    wins += [lines, np.eye(7, dtype=bool), np.eye(7, dtype=bool)[::-1]]
    dots = np.zeros((9, 11), bool)
    dots[1::3, 2::4] = True
    wins += [dots, np.ones((5, 7), bool), np.ones((1, 1), bool), np.zeros((4, 6), bool)]
    edges = np.zeros((10, 12), bool)
    edges[0, 3:6] = edges[9, 0:2] = edges[4:7, 0] = edges[2:8, 11] = edges[9, 11] = True
    wins.append(edges)
    ties = np.zeros((12, 20), bool)
    ties[1:4, 1:4] = ties[6:9, 12:15] = ties[1:4, 15:18] = True  # three equal squares
    wins.append(ties)
    flat = np.zeros((8, 12), bool)  # every contour of area 0: lines and an L
    flat[1, 1:5] = flat[3:6, 8] = flat[6, 2:4] = True
    flat[5, 2] = True
    wins.append(flat)
    return [w.astype(np.uint8) for w in wins]


def _trace_windows(tracer, windows, origins=None):
    """The tracer over a list of separate uint8 windows -> each window's
    largest contour as (K, 2) float64, shifted by its origin, or None."""
    if not windows:
        return []
    sizes = np.array([w.size for w in windows], np.int64)
    geo = np.stack([np.cumsum(sizes) - sizes, [w.shape[1] for w in windows],
                    [w.shape[0] for w in windows]], 1).astype(np.int64)
    fg = np.zeros((len(windows), 4), np.int32)
    fg[:, 2] = np.where(sizes > 0, geo[:, 1] - 1, -1)
    fg[:, 3] = geo[:, 2] - 1
    base = np.concatenate([np.ascontiguousarray(w, np.uint8).ravel() for w in windows])
    counts = np.zeros(len(windows), np.int32)
    points = np.zeros((max(int(sizes.sum()), 16), 2), np.int32)
    need = tracer.largest(base, geo, fg, None, points, counts)
    if need > len(points):
        points = np.zeros((need, 2), np.int32)
        tracer.largest(base, geo, fg, None, points, counts)
    return _split(points, counts, np.zeros((len(windows), 2), np.int64) if origins is None else origins)


def _split(points, counts, origins):
    """The tracer's packed points -> a (K, 2) float64 polygon a word, shifted
    by its origin, or None where it found none."""
    found = counts > 0
    total = int(counts[found].sum())
    pts = points[:total].astype(np.float64)
    pts += np.repeat(origins[found], counts[found], axis=0)
    polys = iter(np.split(pts, np.cumsum(counts[found])[:-1]))
    return [next(polys) if f else None for f in found]


@functools.lru_cache(maxsize=None)
def native_contours():
    """The native contour tracer where it gives this host's cv2's largest
    contours point for point on the probe windows, else None: then cv2
    traces every word."""
    tracer = load_contours()
    if tracer is None:
        return None
    wins = _probe_windows()
    got = _trace_windows(tracer, wins)
    for g, w in zip(got, wins):
        want = _largest_contour(w, 0, 0)
        if (g is None) != (want is None) or (g is not None and not np.array_equal(g, want)):
            return None
    return tracer


def _round16(n):
    return (n + 15) // 16 * 16


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


class _Slot:
    """The buffers of one launch at a time: the inputs staged in pinned
    memory and their copy on the card, the pinned windows and flags the
    kernel writes, the contour tracer's points and counts, and a stream
    and an event of the paster's own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.event = torch.cuda.Event() if self.cuda else None
        self.stage = self.dev = self.out = self.flags = self.fg = None
        self.points = np.zeros((1 << 18, 2), np.int32)
        self.counts = np.zeros(256, np.int32)

    def reserve(self, in_bytes: int, out_bytes: int, n: int) -> None:
        if self.stage is None or self.stage.numel() < in_bytes:
            size = _pow2(max(in_bytes, 1 << 20))
            self.stage = torch.empty(size, dtype=torch.uint8, pin_memory=self.cuda)
            if self.cuda:
                with torch.cuda.stream(self.stream):
                    self.dev = torch.empty(size, dtype=torch.uint8, device=self.device)
            else:
                self.dev = self.stage
        if self.out is None or self.out.numel() < out_bytes:
            self.out = torch.empty(_pow2(max(out_bytes, 16 << 20)), dtype=torch.uint8, pin_memory=self.cuda)
        if self.flags is None or self.flags.numel() < n:
            self.flags = torch.empty(_pow2(max(n, 256)), dtype=torch.int32, pin_memory=self.cuda)
            self.fg = torch.empty((self.flags.numel(), 4), dtype=torch.int32, pin_memory=self.cuda)
            self.counts = np.zeros(self.flags.numel(), np.int32)


class RotatedMaskPaster:
    """``rotated_masks_to_polygons`` on a CUDA device: the same polygons,
    with every word's warp and threshold in one launch of K3 an image.

    Per image: the word table on the host in one pass (``word_windows``,
    the tile table, 16-byte aligned window offsets); one copy of the masks
    and table to the card and K3 on a stream of the paster's own (the
    default stream may be queued behind another thread's model program);
    a wait on an event; then one call of the native contour tracer over
    the pinned windows, each cut to the foreground box K3 returns with it
    (the same contours, shifted), which leaves each word's largest contour
    in the slot's points.  A word K3 flags on the knife edge, or whose
    coordinates are out of its range, is warped by cv2 as in the loop, and
    traced the same way.  Where this host's cv2 warps in neither of K3's
    forms (``host_form``), every word is; where the tracer is not cv2's
    point for point (``native_contours``), cv2 traces every word.  Threads
    post-processing at once each take a slot of buffers of their own.  On
    the CPU (the tests' stand-in for the card) K3's plain version fills the
    same buffers."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self._free: list = []
        self._lock = threading.Lock()
        native_contours()  # the tracer's build and probe: in set-up, not in a request

    def __call__(self, masks: np.ndarray, boxes: np.ndarray, image_shape, threshold: float = 0.5):
        n = len(masks)
        if n == 0:
            return []
        form = host_form()
        tracer = native_contours()
        win, fwd, inv = word_windows(boxes, image_shape, masks.shape[1:])
        x0, y0, x1, y1 = win.T
        w, h = x1 - x0, y1 - y0
        nonempty = (w > 0) & (h > 0)
        reach = np.zeros(n)
        for xs, ys in ((0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1)):
            reach = np.maximum(reach, np.maximum(np.abs(inv[:, 0] * xs + inv[:, 1] * ys + inv[:, 2]),
                                                 np.abs(inv[:, 3] * xs + inv[:, 4] * ys + inv[:, 5])))
        on_card = nonempty & np.isfinite(inv).all(1) & (reach < COORD_LIMIT) & (form is not None)
        polys = [None] * n
        host = list(np.flatnonzero(nonempty & ~on_card))
        idx = np.flatnonzero(on_card)
        sizes = _round16(w[idx] * h[idx])
        start, acc = 0, 0
        for j, size in enumerate(sizes):
            if acc and acc + size > LAUNCH_BYTES:
                host += self._launch(idx[start:j], masks, win, fwd, inv, form, threshold, tracer, polys)
                start, acc = j, 0
            acc += size
        if len(idx):
            host += self._launch(idx[start:], masks, win, fwd, inv, form, threshold, tracer, polys)
        windows = [_host_window(masks[i], fwd[i], win[i], threshold) for i in host]
        if tracer is not None:
            for i, poly in zip(host, _trace_windows(tracer, windows, win[host, :2])):
                polys[i] = poly
            trace.count("glass.post.polygons.native_words", len(host))
        else:
            for i, window in zip(host, windows):
                polys[i] = _largest_contour(window, *win[i][:2])
            trace.count("glass.post.polygons.cv2_words", len(host))
        trace.count("glass.post.polygons.device_words", len(idx))
        trace.count("glass.post.polygons.fallback_words", len(host))
        return polys

    def _launch(self, idx, masks, win, fwd, inv, form, threshold, tracer, polys):
        """K3 over the words ``idx``; their polygons into ``polys``.
        Returns the words it flagged."""
        n, m = len(idx), masks.shape[-1]
        x0, y0, x1, y1 = win[idx].T
        w, h = x1 - x0, y1 - y0
        ends = np.cumsum(_round16(w * h))
        geo = np.stack([ends - _round16(w * h), w, h], 1)
        tiles = k3.tile_table(geo)
        parts = [n * m * m * 4, n * 48, n * 24, len(tiles) * 8, n * 16]
        offs = np.concatenate([[0], np.cumsum([_round16(p) for p in parts])])
        slot = self._acquire()
        try:
            slot.reserve(int(offs[-1]), int(ends[-1]), n)
            stage = slot.stage.numpy()
            stage[offs[0]:offs[0] + parts[0]].view(np.float32).reshape(n, m, m)[:] = masks[idx]
            stage[offs[1]:offs[1] + parts[1]].view(np.float64).reshape(n, 6)[:] = inv[idx]
            stage[offs[2]:offs[2] + parts[2]].view(np.int64).reshape(n, 3)[:] = geo
            stage[offs[3]:offs[3] + parts[3]].view(np.int32).reshape(-1, 2)[:] = tiles
            stage[offs[4]:offs[4] + parts[4]].view(np.int32).reshape(n, 4)[:] = (k3.NO_FG, k3.NO_FG, -1, -1)
            flags, fg = slot.flags.numpy(), slot.fg.numpy()
            flags[:n] = 0
            inputs = _inputs(slot.dev, offs, parts, n, m)
            if slot.cuda:
                with torch.cuda.stream(slot.stream):
                    slot.dev[:int(offs[-1])].copy_(slot.stage[:int(offs[-1])], non_blocking=True)
                    k3.paste_binarize(*inputs, form, threshold, KNIFE_EDGE, slot.out, slot.flags,
                                      slot.stream)
                    slot.fg[:n].copy_(inputs[4], non_blocking=True)
                    slot.event.record(slot.stream)
                slot.event.synchronize()
            else:
                plain, plain_flags, plain_fg = k3.paste_binarize_plain(*inputs[:3], form, threshold,
                                                                       KNIFE_EDGE)
                slot.out[:len(plain)] = plain
                flags[:n], fg[:n] = plain_flags.numpy(), plain_fg.numpy()
            out = slot.out.numpy()
            flagged = list(idx[flags[:n] != 0])
            if tracer is not None:
                self._trace(slot, tracer, out, geo, idx, win, polys)
                trace.count("glass.post.polygons.native_words", n - len(flagged))
                return flagged
            for j, i in enumerate(idx):
                bx0, by0, bx1, by1 = (int(v) for v in fg[j])
                if flags[j] or bx1 < 0:
                    continue  # re-warped on the host; or no foreground: no contour, as the loop finds
                off = int(geo[j, 0])
                window = out[off:off + int(w[j] * h[j])].reshape(int(h[j]), int(w[j]))
                # the contours of the foreground's box are the window's,
                # shifted: findContours pads the image with zeros itself
                polys[i] = _largest_contour(window[by0:by1 + 1, bx0:bx1 + 1], int(x0[j]) + bx0,
                                            int(y0[j]) + by0)
            trace.count("glass.post.polygons.cv2_words", n - len(flagged))
            return flagged
        finally:
            self._release(slot)

    @staticmethod
    def _trace(slot, tracer, out, geo, idx, win, polys):
        """The tracer's one call over a launch's windows (skipping the
        flagged words); each word's points shifted by its window's origin
        and its foreground box's corner."""
        n = len(idx)
        fg, flags, counts = slot.fg.numpy()[:n], slot.flags.numpy()[:n], slot.counts[:n]
        geo = np.ascontiguousarray(geo, np.int64)
        need = tracer.largest(out, geo, fg, flags, slot.points, counts)
        if need > len(slot.points):
            slot.points = np.zeros((_pow2(need), 2), np.int32)
            tracer.largest(out, geo, fg, flags, slot.points, counts)
        origins = win[idx, :2] + fg[:, :2]
        for i, poly in zip(idx, _split(slot.points, counts, origins)):
            polys[i] = poly

    def _acquire(self) -> _Slot:
        with self._lock:
            return self._free.pop() if self._free else _Slot(self.device)

    def _release(self, slot: _Slot) -> None:
        with self._lock:
            self._free.append(slot)


def _inputs(buf, offs, parts, n, m):
    """K3's masks, maps, geo, tiles and foreground boxes: views of one
    staged buffer."""
    view = [buf[offs[k]:offs[k] + parts[k]] for k in range(5)]
    return (view[0].view(torch.float32).view(n, m, m), view[1].view(torch.float64).view(n, 6),
            view[2].view(torch.int64).view(n, 3), view[3].view(torch.int32).view(-1, 2),
            view[4].view(torch.int32).view(n, 4))


def _host_window(mask, fwd, window, threshold):
    x0, y0, x1, y1 = (int(v) for v in window)
    warped = cv2.warpAffine(mask.astype(np.float32), fwd.reshape(2, 3), (x1 - x0, y1 - y0),
                            flags=cv2.INTER_LINEAR)
    return (warped >= threshold).astype(np.uint8)
