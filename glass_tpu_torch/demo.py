"""Single-image demo of the port: ``python -m glass_tpu_torch.demo``.

Counterpart of ``tools/demo.py``: loads a config (and optionally a
detectron2-named ``.pth``), spots text in one image on the GPU, prints the
words and writes the image with the word polygons drawn on it.
"""

from __future__ import annotations

import argparse

import cv2
import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--model", default=None, help="checkpoint .pth (default: seeded random weights)")
    p.add_argument("--output", default="demo_out.png")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--no-post-process", action="store_true")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    from .config import get_cfg
    from .inference import GlassRunner

    cfg = get_cfg(args.config, args.opts)
    runner = GlassRunner(model_path=args.model, cfg=cfg, device=args.device,
                         post_process=not args.no_post_process)
    image = cv2.imread(args.image, cv2.IMREAD_COLOR)
    if image is None:
        raise SystemExit(f"cannot read image {args.image}")
    preds = runner(image)
    texts, scores, _ = runner.decode_texts(preds) if len(preds) else ([], [], [])
    boxes = np.asarray(preds.pred_boxes) if len(preds) else np.zeros((0, 5))
    print(f"{len(preds)} words:")
    for t, s, box in zip(texts, scores, boxes):
        print(f"  {t!r}  score={s:.3f}  box={np.round(box, 1).tolist()}")

    vis = image.copy()
    polygons = preds.pred_polygons if len(preds) and preds.has("pred_polygons") else []
    for poly, text in zip(polygons, texts):
        pts = np.round(np.asarray(poly)).astype(np.int32).reshape(-1, 1, 2)
        cv2.polylines(vis, [pts], True, (0, 255, 0), 2)
        cv2.putText(vis, text, tuple(int(v) for v in pts[0, 0]), cv2.FONT_HERSHEY_SIMPLEX,
                    0.6, (0, 0, 255), 1)
    cv2.imwrite(args.output, vis)
    print(f"visualization written to {args.output}")


if __name__ == "__main__":
    main()
