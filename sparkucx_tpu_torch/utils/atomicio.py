"""Torn-write-proof file writes: temp file in the same directory, flush,
fsync, atomic ``os.replace``, then an fsync of the directory so the
rename itself is durable. A reader of the final path sees either the old
complete content or the new complete content, never a torn prefix. The
spill files' ``.index`` sidecar is written this way
(``shuffle/writer.SpillFiles.finish``)."""

from __future__ import annotations

import os
import threading

__all__ = ["atomic_write_bytes", "atomic_write_text", "fsync_dir"]


def _tmp_name(path: str) -> str:
    # pid + thread id: two writers racing one final path must not
    # truncate each other's temp file
    return f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory, so a rename inside it is durable.
    Never raises: some filesystems refuse to open a directory."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> str:
    """Write ``data`` to ``path`` via temp + (fsync) + atomic rename.
    Returns ``path``."""
    tmp = _tmp_name(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(os.path.dirname(path))
    return path


def atomic_write_text(path: str, text: str, fsync: bool = True) -> str:
    return atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)
