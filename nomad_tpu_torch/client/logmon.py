"""Task log rotation (ref client/logmon/logmon.go + lib/fifo: the reference
runs a logmon subprocess per task collecting FIFO output into size-capped
rotated files).

Here drivers append directly to `<task>.{stdout,stderr}.log` (O_APPEND), so
rotation is copy-truncate: when the live file exceeds its cap it is copied
to `<name>.N` (N growing, oldest pruned past max_files) and truncated in
place — writers never need to reopen, matching the logmon contract that
tasks are unaware of rotation.
"""
from __future__ import annotations

import os
import threading

MB = 1024 * 1024


class LogRotator:
    """Watches a task's two log streams and rotates them by size."""

    def __init__(self, task_dir: str, task_name: str, log_config,
                 check_interval: float = 2.0):
        self.task_dir = task_dir
        self.task_name = task_name
        self.max_files = max(1, getattr(log_config, "max_files", 10))
        self.max_bytes = max(64 * 1024,
                             getattr(log_config, "max_file_size_mb", 10) * MB)
        self.check_interval = check_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"logmon-{self.task_name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval):
            self.rotate_if_needed()

    # ----------------------------------------------------------- rotation

    def _stream_path(self, stream: str) -> str:
        return os.path.join(self.task_dir,
                            f"{self.task_name}.{stream}.log")

    def rotate_if_needed(self) -> int:
        """Rotate any stream over its cap; returns number rotated."""
        n = 0
        for stream in ("stdout", "stderr"):
            path = self._stream_path(stream)
            try:
                if os.path.getsize(path) >= self.max_bytes:
                    self._rotate(path)
                    n += 1
            except OSError:
                continue
        return n

    def _rotate(self, path: str) -> None:
        # shift the numbered chain up; drop the oldest beyond max_files-1
        # (the live file counts against max_files, ref logmon rotator.go)
        keep = self.max_files - 1
        for i in range(keep, 0, -1):
            src = f"{path}.{i}"
            if not os.path.exists(src):
                continue
            if i >= keep:
                os.unlink(src)
            else:
                os.replace(src, f"{path}.{i + 1}")
        # copy a size snapshot, then keep any bytes appended during the
        # copy: read the tail past the snapshot, rewrite it at offset 0,
        # truncate to the tail. O_APPEND writers land at the new EOF, so
        # only appends inside the read->truncate instant can be lost (the
        # reference avoids even that by owning the write path via FIFO).
        size = os.path.getsize(path)
        if keep >= 1:
            # log-rotation copy of a task output stream: loss-tolerant
            # data, fsyncing every rotation would tax the client for
            # bytes nobody re-reads after a crash
            # nomadlint: disable=DUR001 — loss-tolerant log stream
            with open(path, "rb") as src, open(f"{path}.1", "wb") as dst:
                remaining = size
                while remaining > 0:
                    chunk = src.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    dst.write(chunk)
                    remaining -= len(chunk)
        with open(path, "r+b") as f:
            f.seek(size)
            tail = f.read()
            f.seek(0)
            if tail:
                f.write(tail)
            f.truncate(len(tail))

    def rotated_files(self, stream: str = "stdout") -> list[str]:
        path = self._stream_path(stream)
        out = [f"{path}.{i}" for i in range(1, self.max_files)
               if os.path.exists(f"{path}.{i}")]
        return out
