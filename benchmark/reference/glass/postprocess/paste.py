"""Rotated mask pasting (host numpy).

Port of reference ``post_processor_academic.py:187-335``: paste each
predicted 28x28 mask into the full image through a rotated bilinear sampling
grid (the reference loops ``grid_sample`` per instance on GPU; here the
grid inversion is vectorized per instance on the host)."""

from __future__ import annotations

import numpy as np
import cv2


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
        contours, _ = cv2.findContours(
            binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        if not contours:
            polys.append(None)
            continue
        largest = max(contours, key=cv2.contourArea)
        poly = largest.reshape(-1, 2).astype(np.float64)
        if len(poly) < 3:
            polys.append(None)
            continue
        poly += np.array([x0, y0], np.float64)
        polys.append(poly)
    return polys
