"""Structured logging: JSONL records with bound context + a text mirror
(port of ``repro.obs.log``; same records, same file name).

Replaces the fleet workers' ad-hoc ``print -> worker.log`` logging: every
record is one JSON line in ``log.jsonl`` carrying whatever context the
logger was bound with (``worker``, ``batch_id``, ``cell_id``), so a
healed multi-leg fleet run can be grepped/joined by batch or cell after
the fact, while a plain-text mirror (stdout by default — which IS
``worker.log`` for a fleet worker, since the launcher redirects the
process's stdout there) keeps the human-readable stream.

Usage::

    log = JsonlLogger(os.path.join(wdir, "log.jsonl")).bind(worker=2)
    blog = log.bind(batch_id="b0003")
    blog.info("batch started", cells=3)
    blog.bind(cell_id="llama__5nm__high_perf").info("cell done", score=.4)

Records are append-only, newline-guarded against torn tails
(``repro_torch.core.fsutil.torn_tail``) and flushed per record, matching the
campaign store's crash-safety posture.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, Optional, TextIO

from repro_torch.core import fsutil

LOG_NAME = "log.jsonl"


class JsonlLogger:
    """One JSONL log file + optional plain-text mirror.

    ``bind(**ctx)`` returns a child logger that shares the file handle
    and merges its context into every record; binding never mutates the
    parent.  Levels are plain strings (``info``/``warning``/``error``)."""

    def __init__(self, path: Optional[str], *,
                 mirror: Optional[TextIO] = None,
                 context: Optional[Dict] = None,
                 _shared: Optional[Dict] = None):
        self.context = dict(context or {})
        if _shared is not None:            # child: share handle + lock
            self._shared = _shared
        else:
            f = None
            if path is not None:
                os.makedirs(os.path.dirname(os.path.abspath(path)),
                            exist_ok=True)
                lead = "\n" if fsutil.torn_tail(path) else ""
                f = open(path, "a")
                if lead:
                    f.write(lead)
            self._shared = dict(f=f, mirror=(mirror if mirror is not None
                                             else sys.stdout),
                                lock=threading.Lock())

    def bind(self, **ctx) -> "JsonlLogger":
        merged = dict(self.context)
        merged.update(ctx)
        return JsonlLogger(None, context=merged, _shared=self._shared)

    # ----------------------------------------------------------------- emit
    def log(self, level: str, msg: str, **fields) -> None:
        ts = time.time()
        rec = dict(ts=round(ts, 6), level=level, msg=msg)
        rec.update(self.context)
        rec.update(fields)
        f = self._shared["f"]
        mirror = self._shared["mirror"]
        with self._shared["lock"]:
            if f is not None and not f.closed:
                try:
                    f.write(json.dumps(rec, allow_nan=False,
                                       default=str) + "\n")
                    f.flush()
                except (OSError, ValueError):
                    pass               # logging must never kill the search
            if mirror is not None:
                ctx = " ".join(f"{k}={v}" for k, v in self.context.items())
                kv = " ".join(f"{k}={v}" for k, v in fields.items())
                stamp = time.strftime("%H:%M:%S", time.localtime(ts))
                parts = [p for p in (stamp, level.upper(),
                                     f"[{ctx}]" if ctx else "", msg, kv)
                         if p]
                try:
                    print(" ".join(parts), file=mirror, flush=True)
                except (OSError, ValueError):
                    pass

    def info(self, msg: str, **fields) -> None:
        self.log("info", msg, **fields)

    def warning(self, msg: str, **fields) -> None:
        self.log("warning", msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self.log("error", msg, **fields)

    def close(self) -> None:
        f = self._shared["f"]
        with self._shared["lock"]:
            if f is not None and not f.closed:
                f.flush()
                try:
                    os.fsync(f.fileno())
                except OSError:
                    pass
                f.close()


def read_log(path: str) -> list:
    """Decode a log.jsonl, skipping torn lines."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out
