"""Structured logging — the zap-equivalent (reference: zap throughout,
SURVEY §5 Metrics/logging).

Two environments, mirroring ``-log-env`` (cmd/patrol/main.go:31,40-47):

* ``production`` — one JSON object per line (zap.NewProduction style);
* ``development`` — human-readable console lines (zap.NewDevelopment style).

Loggers accept structured fields as ``extra={...}`` kwargs via the helpers
below; buckets render as structured objects (≙ ``MarshalLogObject``,
bucket.go:173-182) through their ``log_fields()`` method.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict

_RESERVED = set(
    logging.LogRecord("", 0, "", 0, "", (), None).__dict__
) | {"message", "asctime", "taskName"}


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "level": record.levelname.lower(),
            "ts": round(time.time(), 6),  # patrol-lint: clock-seam (log stamp)
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        for key, val in record.__dict__.items():
            if key not in _RESERVED and not key.startswith("_"):
                try:
                    json.dumps(val)
                    out[key] = val
                except (TypeError, ValueError):
                    out[key] = repr(val)
        return json.dumps(out, separators=(",", ":"))


class ConsoleFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        fields = " ".join(
            f"{k}={v!r}"
            for k, v in record.__dict__.items()
            if k not in _RESERVED and not k.startswith("_")
        )
        base = f"{ts}\t{record.levelname}\t{record.name}\t{record.getMessage()}"
        if fields:
            base += "\t" + fields
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


def configure(env: str = "production", level: int | None = None) -> logging.Logger:
    """Configure and return the root ``patrol`` logger.

    ``env``: ``production`` (JSON, INFO) or ``development`` (console, DEBUG)
    — unknown values raise, like main.go:46's fatal on bad ``-log-env``.
    """
    if env == "production":
        formatter: logging.Formatter = JSONFormatter()
        default_level = logging.INFO
    elif env == "development":
        formatter = ConsoleFormatter()
        default_level = logging.DEBUG
    else:
        raise ValueError(f"unsupported log env {env!r}")

    logger = logging.getLogger("patrol")
    logger.setLevel(level if level is not None else default_level)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(formatter)
    logger.handlers[:] = [handler]
    logger.propagate = False
    return logger
