"""Single-image demo of the port: ``python -m glass_tpu_torch.demo``.

Counterpart of ``tools/demo.py``: loads a config (and optionally a
detectron2-named ``.pth``), spots text in one image on the GPU (``--device
cpu`` on the CPU), prints the words and writes a visualization with the
port's copy of glass_tpu's visualizer: ``--output`` ending in ``.html`` is
the interactive hover page (transcriptions, text and character scores),
anything else the matplotlib figure.
"""

from __future__ import annotations

import argparse
import os

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
    from .utils.visualizer import visualize, visualize_html

    cfg = get_cfg(args.config, args.opts)
    runner = GlassRunner(model_path=args.model, cfg=cfg, device=args.device,
                         post_process=not args.no_post_process)
    image = cv2.imread(args.image, cv2.IMREAD_COLOR)
    if image is None:
        raise SystemExit(f"cannot read image {args.image}")
    preds = runner(image)
    texts, scores, char_scores = runner.decode_texts(preds) if len(preds) else ([], [], [])
    print(f"{len(preds)} words:")
    for t, s, box in zip(texts, scores, np.asarray(preds.pred_boxes) if len(preds) else []):
        print(f"  {t!r}  score={s:.3f}  box={np.round(box, 1).tolist()}")

    if args.output.endswith(".html"):
        visualize_html(image[:, :, ::-1], preds, texts, text_scores=scores, char_scores=char_scores,
                       save_path=args.output, title=os.path.basename(args.image))
    else:
        visualize(image[:, :, ::-1], preds, texts, scores, save_path=args.output)
    print(f"visualization written to {args.output}")


if __name__ == "__main__":
    main()
