from .node import CfgNode
from .defaults import get_default_config, CHARACTER_SET


def get_cfg(config_file: str | None = None, opts: list | None = None) -> CfgNode:
    """Build a config: defaults -> optional YAML file -> optional CLI opts."""
    cfg = get_default_config()
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg
