"""Durable-write helpers shared by the campaign store, checkpoint
manager and fleet lease files.  Crash-safety-critical: the atomic
tmp-write -> fsync -> rename -> dir-fsync sequence these modules rely on
is only power-loss safe if the data hits disk BEFORE the rename
publishes it."""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict


def fsync_file(path: str) -> None:
    """fsync an already-written file by path (O_RDONLY fds are fine for
    fsync on the platforms we support)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, payload: Dict) -> None:
    """tmp-write -> fsync -> rename -> dir fsync.

    The fsync BEFORE ``os.replace`` is load-bearing: without it a power
    loss after the rename can leave ``path`` pointing at a tmp file whose
    data blocks never hit disk — a truncated file shadowing a valid
    manifest.  With it, the rename atomically publishes fully-durable
    bytes, so a reader always sees either the old or the new file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_" +
                               os.path.basename(path) + "_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, allow_nan=False)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(d)
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def torn_tail(path: str) -> bool:
    """True if a previous appender died mid-line (no trailing newline).
    The next append should then start on a fresh line so the torn tail
    stays one skippable line instead of corrupting the new record too.
    Shared by the campaign store's cell JSONL and the obs trace writer."""
    try:
        with open(path, "rb") as f:
            f.seek(-1, os.SEEK_END)
            return f.read(1) != b"\n"
    except (OSError, ValueError):
        return False


def fsync_dir(path: str) -> None:
    """Persist a rename: fsync the containing directory (no-op where the
    filesystem does not support directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
