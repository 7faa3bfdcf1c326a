"""Hierarchical logging severity config — ≙ the reference's log-warper
YAML configs (time-warp's `bench/logging.yaml`,
``defaultLogConfig`` in bench Commons.hs:85-108): a tree of sublogger
names with per-subtree severities, e.g. the bench muting transport
noise with ``comm: Error`` under each node logger.

Mapped onto Python ``logging``: a config dict (or YAML file) sets
per-logger levels; child loggers inherit (the ``logging`` module's
dotted-name hierarchy ≙ log-warper's ``LoggerName`` tree).

Config shape (mirrors logging.yaml):

    {"severity": "Warning",            # root level
     "sender":   {"severity": "Info",
                  "comm": {"severity": "Error"}},
     "receiver": {"severity": "Info"}}
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

__all__ = ["configure_logging", "load_log_config", "SEVERITIES"]

#: log-warper severity names → logging levels (Commons.hs:85-108).
SEVERITIES = {
    "Debug": logging.DEBUG,
    "Info": logging.INFO,
    "Notice": logging.INFO,
    "Warning": logging.WARNING,
    "Error": logging.ERROR,
}


def _apply(prefix: str, node: Dict[str, Any]) -> None:
    for key, val in node.items():
        if key == "severity":
            logging.getLogger(prefix or None).setLevel(
                SEVERITIES[val] if isinstance(val, str) else val)
        elif isinstance(val, dict):
            child = f"{prefix}.{key}" if prefix else key
            _apply(child, val)
        else:
            raise ValueError(
                f"log config: {key!r} must be 'severity' or a subtree")


def configure_logging(config: Dict[str, Any], *,
                      root: str = "") -> None:
    """Apply a severity tree under logger ``root`` (default: the root
    logger — ≙ ``traverseLoggerConfig``)."""
    _apply(root, config)


def load_log_config(path: Optional[str], *,
                    default: Optional[Dict[str, Any]] = None) -> None:
    """≙ ``loadLogConfig`` (Commons.hs:110-113): read a YAML config
    file, or fall back to ``default`` (or do nothing)."""
    if path is None:
        if default:
            configure_logging(default)
        return
    import yaml
    with open(path, encoding="utf-8") as f:
        cfg = yaml.safe_load(f) or {}
    configure_logging(cfg)
