"""Dataset evaluation of the port: ``python -m glass_tpu_torch.eval``.

Counterpart of ``tools/eval_glass.py`` with the same arguments, the same
eval-time overrides (``eval_glass.py:82-114`` of the reference: NMS 0.35,
text-score 0.3, det-score 0.65, min-size 1000/1600, mask inference on,
orientation overwrite off) merged BEFORE the CLI opts, so explicit opts win,
and the same outputs: ``results.json`` with E2E and detection-only
precision/recall/hmean per dataset under the RRC protocol, a
``<dataset>_det.zip`` of the detections and ``<dataset>_per_sample.json``.
``--device`` picks the card (``cuda``, the default) or the CPU.

    python -m glass_tpu_torch.eval --config configs/glass_finetune_icdar15.yaml \\
        --datasets data_configs/example_datasets.yaml --model model.pth \\
        --batch-size 4 --output eval_out

``--tta`` (or ``TEST.AUG.ENABLED``) evaluates image by image through
``inference.tta.GlassRunnerWithTTA.eval_call``, whatever ``--batch-size``
is, as the reference does.

Under ``torchrun`` (the environment names a group of more than one
process) each rank evaluates ``records[rank::world]`` on ``cuda:LOCAL_RANK``
(gloo on ``--device cpu``), the evaluator gathers the shards, and rank 0
writes ``results.json`` and the det zip:

    torchrun --nproc_per_node 8 -m glass_tpu_torch.eval --config ... --datasets ... --model ...
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import time

import cv2

logger = logging.getLogger("glass_tpu_torch.eval")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate the GLASS text spotter (PyTorch port)")
    p.add_argument("--model", required=False, default=None, help=".pth checkpoint")
    p.add_argument("--config", required=True, help="model config yaml")
    p.add_argument("--datasets", default=None, help="dataset config yaml")
    p.add_argument("--output", default="./eval_output")
    p.add_argument("--gt-zip", default=None, help="RRC gt zip (else gt from dataset json)")
    p.add_argument("--word-spotting", action="store_true")
    p.add_argument("--lexicon", default=None, help="ad-hoc lexicon txt file")
    p.add_argument("--weighted-ed", action="store_true")
    # Benchmark lexicon protocol (reference cfg.TEST.LEXICON_TYPE):
    p.add_argument("--lexicon-type", type=int, default=None,
                   help="0 none / 1 generic / 2 weak / 3 per-image strong")
    p.add_argument("--lexicon-path", default=None, help="types 1/2 lexicon txt")
    p.add_argument("--lexicon-pairs", default=None, help="types 1/2 pairs txt")
    p.add_argument("--strong-lexicon-dir", default=None,
                   help="type 3: dir of new_voc_img_<i>.txt / pair_voc_img_<i>.txt")
    p.add_argument("--tta", action="store_true",
                   help="test-time augmentation (TEST.AUG multi-scale + flip)")
    p.add_argument("--params", action="store_true",
                   help="print the per-module parameter census "
                        "(reference eval_glass.py:147-181)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--bench-log", default=None,
                   help="append per-batch JSONL timing/RSS records here")
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1 runs batched inference per bucket (eval_batch_call)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def setup(args):
    from .config import get_cfg, merge_from_dataset_config
    from .utils.logger import setup_logger

    cfg = get_cfg(args.config)
    if args.datasets:
        merge_from_dataset_config(cfg, args.datasets)
    # Reference eval-time overrides (tools/eval_glass.py:82-114); the
    # reference merges ``args.opts`` AFTER this block (eval_glass.py:117),
    # so explicit CLI opts win over the protocol defaults.
    cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.35
    cfg.INFERENCE_TH_TEST = 0.3
    cfg.INFERENCE_DETECTION_TH_TEST = 0.65
    cfg.POST_PROCESSING.TEXT_THRESHOLD = 0.3
    cfg.POST_PROCESSING.DETECT_THRESHOLD = 0.65
    cfg.INPUT.MIN_SIZE_TEST = 1000
    cfg.INPUT.MAX_SIZE_TEST = 1600
    cfg.MODEL.ROI_MASK_HEAD.MASK_INFERENCE = True
    cfg.MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES = False
    if args.opts:
        cfg.merge_from_list(args.opts)
    # Lexicon protocol flags -> config keys (reference eval_glass.py:101-104).
    if args.lexicon_type is not None:
        cfg.TEST.LEXICON_TYPE = args.lexicon_type
    if args.lexicon_path:
        cfg.TEST.LEXICON_PATH = args.lexicon_path
    if args.lexicon_pairs:
        cfg.TEST.LEXICON_PAIRS_PATH = args.lexicon_pairs
    if args.strong_lexicon_dir:
        cfg.TEST.STRONG_LEXICON_DIR = args.strong_lexicon_dir
    if args.weighted_ed:
        cfg.TEST.LEXICON_WEIGHTED = True
    if args.weighted_ed or cfg.TEST.LEXICON_WEIGHTED:
        # Weighted edit distance consumes the full per-step character
        # distributions — keep them on the host fetch path.
        cfg.TPU.TEXT_EMIT = "probs"
    if args.word_spotting:
        cfg.IS_WORD_SPOTTING = True
    setup_logger(output=args.output)
    return cfg


def main(argv=None) -> dict:
    """Run the evaluation; returns the per-dataset results it also writes
    to ``<output>/results.json``."""
    args = parse_args(argv)
    from .parallel import mesh

    device = args.device
    joined = not mesh.is_distributed() and int(os.environ.get("WORLD_SIZE", "1") or 1) > 1
    if joined:
        device = mesh.init_from_env(args.device)
    try:
        return _evaluate(args, device)
    finally:
        if joined:
            mesh.destroy()


def _evaluate(args, device) -> dict:
    from .data import DatasetManager
    from .evaluation import Lexicon, TextEvaluator
    from .inference import GlassRunner
    from .parallel import mesh

    cfg = setup(args)
    rank, world = mesh.rank(), mesh.world_size()
    runner = GlassRunner(model_path=args.model, cfg=cfg, device=device)
    if args.params:
        from .utils.common import format_parameter_census, parameter_census

        print(format_parameter_census(parameter_census(runner.model), per_param=True))
    tta_runner = None
    if args.tta or cfg.TEST.AUG.ENABLED:
        from .inference.tta import GlassRunnerWithTTA

        logger.info("Running inference with test-time augmentation ...")
        tta_runner = GlassRunnerWithTTA(runner)
    lexicon = None
    if args.lexicon:
        lexicon = Lexicon.from_file(args.lexicon, weighted=args.weighted_ed)

    DatasetManager(cfg).register()
    all_results = {}
    for dataset_name in cfg.DATASETS.TEST:
        records = DatasetManager.load(dataset_name)
        if args.max_images:
            records = records[: args.max_images]
        # more than one process: a strided shard each; TextEvaluator.evaluate()
        # gathers them, so every rank reports the metrics of the whole set
        records = records[rank::world]
        gt_zip = args.gt_zip
        if not gt_zip:
            # Configured gt archives (DATASETS.EVAL_GT_ZIPS.*) by name match.
            for key, path in cfg.DATASETS.EVAL_GT_ZIPS.items():
                if path and key.lower() in dataset_name.lower():
                    gt_zip = path
                    break
        evaluator = TextEvaluator(
            dataset_name,
            cfg,
            output_dir=args.output,
            gt_zip=gt_zip,
            word_spotting=True if args.word_spotting else None,
            lexicon=lexicon,
        )
        t0 = time.time()
        chunk = max(args.batch_size, 1)
        for start in range(0, len(records), chunk):
            batch_records, batch_images = [], []
            for record in records[start : start + chunk]:
                image = cv2.imread(record["file_name"], cv2.IMREAD_COLOR)
                if image is None:
                    logger.warning("unreadable: %s", record["file_name"])
                    continue
                batch_records.append(record)
                batch_images.append(image)
            if not batch_images:
                continue
            if tta_runner is not None:
                preds_list = [tta_runner.eval_call(im) for im in batch_images]
            elif chunk == 1:
                preds_list = [runner.eval_call(batch_images[0])]
            else:
                preds_list = runner.eval_batch_call(batch_images, batch_size=chunk)
            for record, preds in zip(batch_records, preds_list):
                key = str(record.get("image_id", start))
                evaluator.process(key, preds, gt_record=record)
            done = min(start + chunk, len(records))
            if args.bench_log:
                with open(args.bench_log, "a") as bf:
                    bf.write(json.dumps({
                        "dataset": dataset_name,
                        "done": done,
                        "elapsed_s": round(time.time() - t0, 4),
                        "rss_mb": round(
                            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1
                        ),
                    }) + "\n")
            if done % 50 < chunk:
                rate = done / (time.time() - t0)
                logger.info("%s: %d/%d images (%.2f img/s)", dataset_name, done, len(records), rate)
        results = evaluator.evaluate()
        all_results[dataset_name] = results
        logger.info("%s results: %s", dataset_name, json.dumps(results, indent=2))

    if rank == 0:
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "results.json"), "w") as f:
            json.dump(all_results, f, indent=2)
        print(json.dumps(all_results, indent=2))
    return all_results


if __name__ == "__main__":
    main()
