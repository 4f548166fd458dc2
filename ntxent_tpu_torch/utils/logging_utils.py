"""Logging setup, counterpart of ``ntxent_tpu/utils/logging_utils.py``
(stdlib).

``setup_logging`` reconfigures deterministically: the requested level
always takes effect, and the formatter of the root handlers this module
installed is swapped in place (``logging.basicConfig`` alone is a silent
no-op once any handler exists).

``format_kv`` / ``KeyValueFormatter`` are the ``key=value`` rendering of
the event log's mirror mode (``obs.events.EventLog(mirror_logger=True)``):
one greppable line per record, values quoted only when they need it.
"""

from __future__ import annotations

import json
import logging

__all__ = ["KeyValueFormatter", "format_kv", "setup_logging"]

_DEFAULT_FORMAT = "%(asctime)s - %(levelname)s - %(message)s"
_KV_FORMAT = "%(asctime)s %(levelname)s %(message)s"


def format_kv(fields: dict) -> str:
    """``key=value`` pairs in insertion order. Values holding whitespace,
    quotes or '=' (or empty) are JSON-quoted so the line splits on spaces;
    None renders as ``key=null``."""
    parts = []
    for key, value in fields.items():
        if value is None:
            rendered = "null"
        elif isinstance(value, bool):
            rendered = "true" if value else "false"
        elif isinstance(value, (int, float)):
            rendered = repr(value)
        else:
            text = str(value)
            needs_quote = any(c in text for c in ' \t\n"=') or not text
            rendered = json.dumps(text) if needs_quote else text
        parts.append(f"{key}={rendered}")
    return " ".join(parts)


class KeyValueFormatter(logging.Formatter):
    """``asctime level key=value ...`` lines: a dict record renders as its
    pairs, a plain string record as it is."""

    def __init__(self, datefmt: str | None = None):
        super().__init__(fmt=_KV_FORMAT, datefmt=datefmt)

    def format(self, record: logging.LogRecord) -> str:
        if isinstance(record.msg, dict):
            # a copy: a dict msg with args would fail %-interpolation
            record = logging.makeLogRecord(record.__dict__)
            record.msg = format_kv(record.msg)
            record.args = ()
        return super().format(record)


def setup_logging(level: int = logging.INFO,
                  structured: bool = False) -> logging.Logger:
    """Idempotent root-logger configuration. The first call installs a
    handler (``basicConfig``) and tags it; later calls set the root level
    and swap the formatter of the tagged handlers only, so repeated setup
    converges on the last request and other libraries' handlers stay as
    they are. ``structured=True`` formats with ``KeyValueFormatter``."""
    root = logging.getLogger()
    formatter: logging.Formatter = (
        KeyValueFormatter() if structured
        else logging.Formatter(_DEFAULT_FORMAT))
    if not root.handlers:
        logging.basicConfig(level=level)
        for handler in root.handlers:
            handler._ntxent_managed = True
            handler.setFormatter(formatter)
    else:
        root.setLevel(level)
        for handler in root.handlers:
            if getattr(handler, "_ntxent_managed", False):
                handler.setFormatter(formatter)
    return logging.getLogger("ntxent_tpu_torch")
