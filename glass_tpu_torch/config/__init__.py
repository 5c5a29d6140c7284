import os

import yaml

from .node import CfgNode
from .defaults import get_default_config, CHARACTER_SET


def merge_from_dataset_config(cfg: CfgNode, dataset_config_path: str) -> None:
    """Merge a dataset YAML (DATASETS/VAL_DATASETS/ROOT keys) into the config.

    Mirrors reference ``glass/config.py:217-226``.
    """
    with open(dataset_config_path, "r") as fp:
        dataset_config = yaml.safe_load(fp) or {}
    cfg.DATASETS.TRAIN = dataset_config.get("DATASETS", [])
    cfg.DATASETS.TEST = dataset_config.get("VAL_DATASETS", [])
    cfg.DATASETS.ROOT = dataset_config.get("ROOT", ".")
    cfg.DATASETS.CONFIG = os.path.basename(dataset_config_path)


def get_cfg(config_file: str | None = None, opts: list | None = None) -> CfgNode:
    """Build a config: defaults -> optional YAML file -> optional CLI opts."""
    cfg = get_default_config()
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg
