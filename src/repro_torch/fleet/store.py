"""File-backed rendezvous store — the fleet's sidecar KV + append-log substrate.

Every cross-process surface in :mod:`repro_torch.fleet` (membership records,
heartbeats, join requests, step-time sample streams) is a key or an append-only
log in one shared directory, so a fleet needs nothing but a filesystem both
sides can see — no external services, no extra dependencies, and every byte of
coordination state is inspectable with ``cat`` after a failed drill.

Two primitives, two atomicity guarantees:

* **keys** (:meth:`FileStore.put` / :meth:`FileStore.get`) are single JSON
  documents written via the tmp-file + ``os.replace`` pattern the checkpoint
  layer established — a reader sees the old value or the new value, never a
  torn one;
* **logs** (:meth:`FileStore.append` / :meth:`FileStore.read_log`) are JSONL
  files opened with ``O_APPEND``; one record is one ``write()`` well under
  ``PIPE_BUF``, so concurrent appenders interleave at line granularity.
  Readers track a byte offset and only consume *complete* lines, so a reader
  racing an in-flight append simply picks the tail up next call.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

__all__ = ["FileStore"]

#: keys/log names are path-like but constrained — no traversal, no surprises
_KEY_RE = re.compile(r"^[A-Za-z0-9_.-]+(/[A-Za-z0-9_.-]+)*$")


class FileStore:
    """Atomic JSON keys + append-only JSONL logs under one root directory."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # -- paths -----------------------------------------------------------------
    def _path(self, key: str, suffix: str) -> str:
        # the regex admits dots inside segments ("a.b"), so "." / ".."
        # segments need an explicit reject or a key could escape the root
        if not _KEY_RE.match(key) or any(
            seg in (".", "..") for seg in key.split("/")
        ):
            raise ValueError(f"invalid store key {key!r}")
        return os.path.join(self.root, *key.split("/")) + suffix

    # -- keys ------------------------------------------------------------------
    def put(self, key: str, value: dict[str, Any]) -> None:
        """Atomically replace ``key`` with ``value`` (tmp + ``os.replace``)."""
        path = self._path(key, ".json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(value, f)
        os.replace(tmp, path)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            with open(self._path(key, ".json"), encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            # a missing key and a key being replaced mid-read look the same
            # to a poller: absent now, present next poll
            return default

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key, ".json"))
        except FileNotFoundError:
            pass

    def scan(self, prefix: str) -> dict[str, Any]:
        """All keys under ``prefix/`` (one directory level), parsed."""
        directory = os.path.join(self.root, *prefix.split("/"))
        out: dict[str, Any] = {}
        try:
            names = sorted(os.listdir(directory))
        except FileNotFoundError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            key = f"{prefix}/{name[:-len('.json')]}"
            value = self.get(key)
            if value is not None:
                out[key] = value
        return out

    # -- logs ------------------------------------------------------------------
    def append(self, log: str, record: dict[str, Any]) -> None:
        """Append one JSONL record (single ``O_APPEND`` write: concurrent
        appenders interleave at line granularity, never mid-line)."""
        path = self._path(log, ".jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        line = (json.dumps(record) + "\n").encode("utf-8")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)

    def read_log(self, log: str, offset: int = 0) -> tuple[list[dict[str, Any]], int]:
        """Complete records at/after byte ``offset`` + the next offset.

        Only lines terminated by ``\\n`` are consumed — a record mid-append
        stays in the file for the next read.  Undecodable complete lines are
        skipped (counted against no one: the store is a transport, policy on
        bad peers lives in the fencing layer above).
        """
        path = self._path(log, ".jsonl")
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read()
        except FileNotFoundError:
            return [], offset
        records: list[dict[str, Any]] = []
        consumed = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # in-flight append: leave for the next read
            consumed += len(line)
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return records, offset + consumed

    def logs(self, prefix: str) -> list[str]:
        """Log names under ``prefix/`` (one directory level)."""
        directory = os.path.join(self.root, *prefix.split("/"))
        try:
            names = sorted(os.listdir(directory))
        except FileNotFoundError:
            return []
        return [
            f"{prefix}/{n[:-len('.jsonl')]}" for n in names if n.endswith(".jsonl")
        ]
