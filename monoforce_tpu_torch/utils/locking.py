"""File-lock protected CSV writing (reference: utils.py:300-354 PathLock +
write_to_csv/append_to_csv), rebuilt on fcntl instead of a lock-file
spin loop; own copy of ``monoforce_tpu/utils/locking.py``."""

from __future__ import annotations

import fcntl
import os
from contextlib import contextmanager

__all__ = ["PathLock", "write_to_csv", "append_to_csv"]


@contextmanager
def PathLock(path: str):
    """Exclusive advisory lock scoped to ``path`` (cross-process safe)."""
    lock_path = path + ".lock"
    os.makedirs(os.path.dirname(os.path.abspath(lock_path)), exist_ok=True)
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def write_to_csv(path: str, header: str, rows):
    with PathLock(path):
        with open(path, "w") as f:
            f.write(header if header.endswith("\n") else header + "\n")
            for row in rows:
                f.write(",".join(str(v) for v in row) + "\n")


def append_to_csv(path: str, rows, header: str | None = None):
    with PathLock(path):
        new = not os.path.exists(path) or os.path.getsize(path) == 0
        with open(path, "a") as f:
            if new and header:
                f.write(header if header.endswith("\n") else header + "\n")
            for row in rows:
                f.write(",".join(str(v) for v in row) + "\n")
