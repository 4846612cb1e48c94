"""Resume planning: scan → validate → quarantine → select.

This replaces the silent try-loop ``restore_latest`` used to carry.  A
:func:`plan_resume` pass walks every ``step_XXXXXXXX`` directory (and every
stale ``.tmp`` a killed writer left behind), validates each without loading
it, and produces a :class:`ResumePlan`:

* **valid** checkpoints, newest first — ``selected`` is the newest
  (latest-valid policy) and the remainder are the last-known-good fallbacks
  the loader walks if the selected one fails between validation and load;
* **corrupt** entries are moved into a ``corrupt/`` quarantine next to the
  live checkpoints, each with a ``REASON.txt`` naming the validation failure
  — nothing is deleted, so an operator can inspect (or hand-repair) the
  evidence, and a corrupt directory can never be scanned or loaded again;
* every quarantine bumps the ``ckpt_validation_failures`` and
  ``ckpt_corrupt_detected`` counters and a ``CHECKPOINT/quarantine::<reason>``
  count row, so corruption is visible in the timing report rather than
  silently skipped; a successful selection bumps ``ckpt_resume_selected``.

The scan never deserializes an array: validation is structural + streamed
hashing (:func:`repro_torch.checkpoint.io.validate_checkpoint`).
"""

from __future__ import annotations

import os
import re
import shutil
from dataclasses import dataclass, field
from typing import Any

from ..core.clocks import counter_cell
from ..core.timers import timer_db
from .io import CheckpointCorrupt, validate_checkpoint

__all__ = [
    "CheckpointRecord",
    "ResumePlan",
    "list_quarantined",
    "plan_resume",
    "quarantine_checkpoint",
    "scan_checkpoints",
]

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_RE = re.compile(r"^step_(\d{8})\.tmp$")
_QUARANTINE_DIR = "corrupt"
_REASON_FILE = "REASON.txt"


def _bump(name: str, value: float = 1.0) -> None:
    """Lock-free counter bump, exported so reports can render the channel."""
    from ..timing.session import export_counter_channel

    export_counter_channel(name)
    counter_cell(name)(value)


def _count_row(name: str) -> None:
    """Increment a timer-DB count row (renders in the flat Fig.-2 report)."""
    db = timer_db()
    db.scope_handle(name).timer.count += 1


@dataclass(frozen=True)
class CheckpointRecord:
    """One scanned checkpoint directory and its validation verdict."""

    step: int
    path: str
    status: str  # "valid" | "corrupt" | "stale_tmp"
    reason: str | None = None

    def summary(self) -> dict[str, Any]:
        return {
            "step": self.step,
            "path": self.path,
            "status": self.status,
            "reason": self.reason,
        }


@dataclass
class ResumePlan:
    """The outcome of one resume scan over a checkpoint directory.

    ``selected`` is the newest valid checkpoint (``None`` when nothing valid
    survives); ``records`` holds every scanned entry newest-first and
    ``quarantined`` the subset that was moved into ``corrupt/`` this scan.
    """

    directory: str
    records: list[CheckpointRecord] = field(default_factory=list)
    quarantined: list[CheckpointRecord] = field(default_factory=list)

    @property
    def valid(self) -> list[CheckpointRecord]:
        """Valid checkpoints, newest first: ``valid[0]`` is the latest-valid
        selection, the rest are last-known-good fallbacks in order."""
        return [r for r in self.records if r.status == "valid"]

    @property
    def corrupt(self) -> list[CheckpointRecord]:
        return [r for r in self.records if r.status != "valid"]

    @property
    def selected(self) -> CheckpointRecord | None:
        valid = self.valid
        return valid[0] if valid else None

    def summary(self) -> dict[str, Any]:
        sel = self.selected
        return {
            "directory": self.directory,
            "selected_step": sel.step if sel else None,
            "n_valid": len(self.valid),
            "n_corrupt": len(self.corrupt),
            "n_quarantined": len(self.quarantined),
            "quarantined": [r.summary() for r in self.quarantined],
        }


def scan_checkpoints(directory: str, validate: bool = True) -> list[CheckpointRecord]:
    """Scan ``directory`` for checkpoints and stale writer leftovers.

    Returns records newest-first.  With ``validate=True`` each committed
    directory goes through the full (load-free) validation gate; stale
    ``.tmp`` directories — the debris of a writer killed mid-write — are
    always recorded as ``stale_tmp``.
    """
    if not os.path.isdir(directory):
        return []
    records: list[CheckpointRecord] = []
    for name in sorted(os.listdir(directory), reverse=True):
        full = os.path.join(directory, name)
        m = _TMP_RE.match(name)
        if m is not None:
            records.append(
                CheckpointRecord(int(m.group(1)), full, "stale_tmp", "stale_tmp")
            )
            continue
        m = _STEP_RE.match(name)
        if m is None:
            continue
        step = int(m.group(1))
        if not validate:
            records.append(CheckpointRecord(step, full, "valid"))
            continue
        try:
            validate_checkpoint(full)
        except CheckpointCorrupt as exc:
            records.append(CheckpointRecord(step, full, "corrupt", exc.reason))
        else:
            records.append(CheckpointRecord(step, full, "valid"))
    records.sort(key=lambda r: (r.step, r.path), reverse=True)
    return records


def quarantine_checkpoint(path: str, reason: str, root: str | None = None) -> str:
    """Move a corrupt checkpoint into ``<root>/corrupt/`` with a reason file.

    Returns the quarantine destination.  The move is a rename when possible
    (same filesystem — atomic, no partial state); the reason file records the
    validation failure for post-mortems.  A name collision (same checkpoint
    corrupted twice across restarts) gets a numeric suffix rather than
    overwriting earlier evidence.
    """
    root = root if root is not None else os.path.dirname(os.path.abspath(path))
    qdir = os.path.join(root, _QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    base = os.path.basename(path.rstrip(os.sep))
    dest = os.path.join(qdir, base)
    n = 1
    while os.path.exists(dest):
        dest = os.path.join(qdir, f"{base}.{n}")
        n += 1
    shutil.move(path, dest)
    with open(os.path.join(dest, _REASON_FILE), "w") as f:
        f.write(reason + "\n")
    return dest


def list_quarantined(directory: str) -> list[dict[str, str]]:
    """Quarantined entries under ``directory/corrupt/`` with their reasons."""
    qdir = os.path.join(directory, _QUARANTINE_DIR)
    if not os.path.isdir(qdir):
        return []
    out = []
    for name in sorted(os.listdir(qdir)):
        full = os.path.join(qdir, name)
        if not os.path.isdir(full):
            continue
        reason_path = os.path.join(full, _REASON_FILE)
        reason = ""
        if os.path.exists(reason_path):
            with open(reason_path) as f:
                reason = f.read().strip()
        out.append({"name": name, "path": full, "reason": reason})
    return out


def plan_resume(directory: str, quarantine: bool = True) -> ResumePlan:
    """Scan, quarantine corruption, and select the checkpoint to resume from.

    The latest-valid policy: the newest checkpoint that passes validation is
    selected; everything that fails is quarantined (when ``quarantine=True``)
    with a reason file, counted on ``ckpt_validation_failures`` /
    ``ckpt_corrupt_detected``, and surfaced as a
    ``CHECKPOINT/quarantine::<reason>`` row in the timing report.
    """
    records = scan_checkpoints(directory, validate=True)
    plan = ResumePlan(directory=directory, records=records)
    for record in records:
        if record.status == "valid":
            continue
        _bump("ckpt_validation_failures")
        _bump("ckpt_corrupt_detected")
        _count_row(f"CHECKPOINT/quarantine::{record.reason}")
        if quarantine:
            quarantine_checkpoint(record.path, record.reason or record.status,
                                  root=directory)
            plan.quarantined.append(record)
    if plan.selected is not None:
        _bump("ckpt_resume_selected")
    return plan
