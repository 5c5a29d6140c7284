"""Qualitative visualization of spotting predictions: a copy of
glass_tpu's ``utils/visualizer.py``.

Equivalent of reference ``glass/utils/visualizer.py`` (rendering uses
matplotlib, with the Agg backend, in place of plotly): polygon outlines +
transcriptions rotated along each word box, with scores; and a standalone
HTML page with hover tooltips.  Given the same predictions it draws the
same pixels and writes the same HTML as glass_tpu's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..postprocess.np_geometry import boxes_to_polygons_np


def visualize(
    image_rgb: np.ndarray,
    preds,
    texts: Sequence[str] = (),
    scores: Sequence[float] = (),
    save_path: Optional[str] = None,
    show_order: bool = False,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(14, 14 * image_rgb.shape[0] / image_rgb.shape[1]))
    ax.imshow(image_rgb.astype(np.uint8))
    ax.axis("off")

    if len(preds):
        if preds.has("pred_polygons"):
            polys = np.asarray(preds.pred_polygons)
        else:
            polys = boxes_to_polygons_np(np.asarray(preds.pred_boxes))
        det_scores = np.asarray(preds.scores)
        for i, poly in enumerate(polys):
            closed = np.vstack([poly, poly[:1]])
            ax.plot(closed[:, 0], closed[:, 1], "-", color="lime", linewidth=1.5)
            label = texts[i] if i < len(texts) else ""
            if show_order:
                label = f"{i}:{label}"
            if label:
                top = poly[np.argmin(poly[:, 1])]
                edge = poly[1] - poly[0]
                angle = -np.degrees(np.arctan2(edge[1], edge[0]))
                ax.text(
                    top[0], top[1] - 2, label,
                    color="yellow", fontsize=8, rotation=angle,
                    rotation_mode="anchor",
                    bbox=dict(facecolor="black", alpha=0.4, pad=0.5, edgecolor="none"),
                )
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return None
    return fig


def visualize_html(
    image_rgb: np.ndarray,
    preds,
    texts: Sequence[str] = (),
    scores: Sequence[float] = (),
    text_scores: Sequence[float] = (),
    char_scores: Sequence[Sequence[float]] = (),
    save_path: Optional[str] = None,
    title: Optional[str] = None,
    vis_width: int = 720,
) -> str:
    """Interactive hover visualization as a single standalone HTML file.

    Dependency-free equivalent of the reference's plotly figure
    (``glass/utils/visualizer.py:12-125``): word polygons over the image
    with hover tooltips carrying the transcription, detection score and
    text score — plus per-character step scores (beyond the reference) when
    ``char_scores`` is given.  The image is embedded base64, so the file is
    self-contained and opens in any browser.
    """
    import base64

    import cv2

    h, w = image_rgb.shape[:2]
    scale = vis_width / w
    disp_w, disp_h = int(round(w * scale)), int(round(h * scale))
    resized = cv2.resize(image_rgb.astype(np.uint8), (disp_w, disp_h))
    ok, png = cv2.imencode(".png", resized[:, :, ::-1])  # expects BGR
    assert ok
    b64 = base64.b64encode(png.tobytes()).decode("ascii")

    if len(preds):
        if preds.has("pred_polygons"):
            polys = np.asarray(preds.pred_polygons, dtype=np.float64) * scale
        else:
            polys = boxes_to_polygons_np(np.asarray(preds.pred_boxes)) * scale
        # explicit scores override the instances' own (e.g. re-ranked)
        det_scores = np.asarray(scores) if len(scores) else np.asarray(preds.scores)
    else:
        polys = np.zeros((0, 4, 2))
        det_scores = np.zeros((0,))

    shapes = []
    for i, poly in enumerate(polys):
        pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in poly)
        text = str(texts[i]) if i < len(texts) else ""
        ds = float(det_scores[i]) if i < len(det_scores) else 0.0
        ts = float(text_scores[i]) if i < len(text_scores) else float("nan")
        tip = f"<b>{_esc(text)}</b><br>Detect score: {ds * 100:.1f}"
        if ts == ts:  # not NaN
            tip += f"<br>Text score: {ts * 100:.1f}"
        if i < len(char_scores) and len(char_scores[i]) and text:
            per_char = " ".join(
                f"{_esc(c)}:{s * 100:.0f}"
                for c, s in zip(text, char_scores[i])
            )
            tip += f"<br><span class=c>{per_char}</span>"
        shapes.append(
            f'<polygon points="{pts}" data-tip="{_esc_attr(tip)}"/>'
        )

    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{_esc(title or "glass_tpu predictions")}</title>
<style>
 body {{ margin: 0; font-family: Arial, sans-serif; background: #111; color: #eee; }}
 h3 {{ margin: 8px; font-weight: normal; }}
 .wrap {{ position: relative; display: inline-block; margin: 8px; }}
 svg {{ position: absolute; left: 0; top: 0; }}
 polygon {{ fill: rgba(30,100,255,0.08); stroke: #2060ff; stroke-width: 2.5;
            opacity: .8; cursor: pointer; }}
 polygon:hover {{ fill: rgba(255,200,0,0.25); stroke: #ffc800; opacity: 1; }}
 #tip {{ position: fixed; display: none; background: rgba(0,0,0,.85);
         border: 1px solid #555; padding: 6px 8px; border-radius: 4px;
         pointer-events: none; font-size: 13px; z-index: 10; }}
 #tip .c {{ color: #9c9; font-size: 11px; }}
</style></head><body>
<h3>{_esc(title or "")}</h3>
<div class="wrap">
<img src="data:image/png;base64,{b64}" width="{disp_w}" height="{disp_h}">
<svg width="{disp_w}" height="{disp_h}" viewBox="0 0 {disp_w} {disp_h}">
{chr(10).join(shapes)}
</svg></div>
<div id="tip"></div>
<script>
const tip = document.getElementById('tip');
for (const p of document.querySelectorAll('polygon')) {{
  p.addEventListener('mousemove', e => {{
    tip.innerHTML = p.dataset.tip;
    tip.style.left = (e.clientX + 12) + 'px';
    tip.style.top = (e.clientY + 12) + 'px';
    tip.style.display = 'block';
  }});
  p.addEventListener('mouseleave', () => tip.style.display = 'none');
}}
</script></body></html>"""
    if save_path:
        with open(save_path, "w") as f:
            f.write(html)
    return html


def _esc(s: str) -> str:
    return (
        str(s).replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    )


def _esc_attr(s: str) -> str:
    # data attribute: keep the markup (rendered via innerHTML) but protect
    # the quoting context.
    return str(s).replace("&", "&amp;").replace('"', "&quot;")
