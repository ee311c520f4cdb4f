"""Structured metrics logging (SURVEY §5.5).

The reference surfaces performance only as an on-screen HUD string
(``/root/reference/src/NGLScene.cpp:324-342``) — nothing is recorded.  For
unattended jobs the equivalents need to be machine-readable: this module
writes JSON-lines records (one object per event, wall-clock stamped) that
TensorBoard-style tooling, notebooks, or plain ``jq`` can consume, and the
training step can return a structured metrics dict straight from the jitted
computation (``parallel/sharding.sharded_train_step(with_metrics=True)``).
"""

from __future__ import annotations

import io
import json
import pathlib
import sys
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL event log.

    Every record carries ``event`` (str), ``t`` (seconds since logger
    creation) and ``wall`` (unix time); other fields come from the caller.
    Values are coerced with ``float()``/``int()`` where possible so device
    scalars never leak into the file.  ``path=None`` logs to stderr.
    """

    def __init__(self, path: Optional[str] = None):
        self._t0 = time.time()
        if path is None:
            self._fh: io.TextIOBase = sys.stderr
            self._own = False
        else:
            p = pathlib.Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(p, "a", buffering=1)  # line-buffered
            self._own = True

    @staticmethod
    def _coerce(v):
        if isinstance(v, (str, bool, type(None))):
            return v
        if isinstance(v, int):
            return v
        try:
            f = float(v)
            return int(f) if float(f).is_integer() and abs(f) < 2**53 else f
        except (TypeError, ValueError):
            return str(v)

    def log(self, event: str, **fields) -> dict:
        rec = {
            "event": event,
            "t": round(time.time() - self._t0, 4),
            "wall": round(time.time(), 3),
        }
        rec.update({k: self._coerce(v) for k, v in fields.items()})
        self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
