"""Fault injectors: turn a :class:`~repro_torch.faults.plan.FaultEvent` into real
damage — on disk (checkpoint corruption), on a simulated fleet (slow/hang a
host), or on the process (SIGTERM with a save deadline).

Checkpoint injectors operate on a published checkpoint directory and are the
exact inverse of what the validation layer must catch: a bit flipped in a leaf
(``leaf_hash_mismatch``), a truncated or deleted leaf (``leaf_size_mismatch``/
``missing_leaf``), a deleted or half-written manifest (``missing_manifest``/
``manifest_unreadable``), a dropped COMMIT marker (``missing_commit``), and
the stale ``.tmp`` debris of a writer killed mid-write (``stale_tmp``).  Every
injector is deterministic given an RNG (use
:meth:`~repro_torch.faults.plan.FaultPlan.rng_for`).
"""

from __future__ import annotations

import json
import os
import random
import signal

import numpy as np

from .plan import FaultEvent

__all__ = [
    "apply_checkpoint_event",
    "apply_fleet_event",
    "bit_flip_leaf",
    "drop_commit",
    "drop_leaf",
    "drop_manifest",
    "partial_manifest",
    "send_sigterm",
    "simulate_writer_kill",
    "truncate_leaf",
]

_MANIFEST = "manifest.json"
_COMMIT = "COMMITTED"


def _leaf_files(ckpt_path: str) -> list[str]:
    names = sorted(n for n in os.listdir(ckpt_path) if n.startswith("leaf_"))
    if not names:
        raise FileNotFoundError(f"{ckpt_path}: no leaf files to corrupt")
    return names


def _pick_leaf(ckpt_path: str, leaf_index: int | None, rng: random.Random | None) -> str:
    names = _leaf_files(ckpt_path)
    if leaf_index is not None:
        return os.path.join(ckpt_path, names[leaf_index % len(names)])
    rng = rng if rng is not None else random.Random(0)
    return os.path.join(ckpt_path, rng.choice(names))


def bit_flip_leaf(
    ckpt_path: str, leaf_index: int | None = None, rng: random.Random | None = None
) -> str:
    """Flip one bit of one leaf file (silent storage corruption)."""
    rng = rng if rng is not None else random.Random(0)
    path = _pick_leaf(ckpt_path, leaf_index, rng)
    size = os.path.getsize(path)
    offset = rng.randrange(size)
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ (1 << rng.randrange(8))]))
    return path


def truncate_leaf(
    ckpt_path: str,
    leaf_index: int | None = None,
    keep_fraction: float = 0.5,
    rng: random.Random | None = None,
) -> str:
    """Cut a leaf file short (partial write that still got committed)."""
    path = _pick_leaf(ckpt_path, leaf_index, rng)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(int(size * keep_fraction), 1))
    return path


def drop_leaf(
    ckpt_path: str, leaf_index: int | None = None, rng: random.Random | None = None
) -> str:
    """Delete a leaf file outright (lost object / unlinked extent)."""
    path = _pick_leaf(ckpt_path, leaf_index, rng)
    os.remove(path)
    return path


def drop_manifest(ckpt_path: str) -> str:
    path = os.path.join(ckpt_path, _MANIFEST)
    os.remove(path)
    return path


def partial_manifest(ckpt_path: str, keep_fraction: float = 0.5) -> str:
    """Truncate the manifest mid-JSON (writer crashed during the metadata
    write, after the leaves landed)."""
    path = os.path.join(ckpt_path, _MANIFEST)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(int(size * keep_fraction), 1))
    return path


def drop_commit(ckpt_path: str) -> str:
    path = os.path.join(ckpt_path, _COMMIT)
    os.remove(path)
    return path


def simulate_writer_kill(
    directory: str,
    step: int,
    n_leaves: int = 2,
    leaf_nbytes: int = 4096,
    rng: random.Random | None = None,
) -> str:
    """Leave exactly the debris a SIGKILLed writer leaves: a ``step_*.tmp``
    directory holding partial leaf files, no manifest, no COMMIT marker.

    The atomic-publish protocol means a killed writer can *only* produce this
    state (the final directory appears in one ``os.replace``), so tests and
    soaks inject it directly instead of racing a real subprocess kill.
    """
    rng = rng if rng is not None else random.Random(0)
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    os.makedirs(tmp, exist_ok=True)
    for i in range(n_leaves):
        arr = np.frombuffer(rng.randbytes(leaf_nbytes), dtype=np.uint8)
        path = os.path.join(tmp, f"leaf_{i:05d}.npy")
        with open(path, "wb") as f:
            np.save(f, arr)
        if i == n_leaves - 1:
            # the kill landed mid-write on the last leaf
            with open(path, "r+b") as f:
                f.truncate(max(leaf_nbytes // 2, 1))
    return tmp


def send_sigterm(pid: int | None = None) -> None:
    """Deliver the preemption notice (SIGTERM) — to this process by default.
    The checkpoint manager's installed handler owns the deadline semantics."""
    os.kill(pid if pid is not None else os.getpid(), signal.SIGTERM)


def apply_checkpoint_event(
    event: FaultEvent, ckpt_path: str, rng: random.Random | None = None
) -> str:
    """Dispatch one checkpoint-fault event against a checkpoint directory
    (``kill_writer`` targets the *parent* checkpoint root).  Returns the path
    the injector touched."""
    kind = event.kind
    if kind == "bitflip":
        return bit_flip_leaf(ckpt_path, event.target, rng)
    if kind == "truncate_leaf":
        return truncate_leaf(
            ckpt_path, event.target,
            keep_fraction=event.arg if event.arg is not None else 0.5, rng=rng,
        )
    if kind == "drop_leaf":
        return drop_leaf(ckpt_path, event.target, rng)
    if kind == "drop_manifest":
        return drop_manifest(ckpt_path)
    if kind == "partial_manifest":
        return partial_manifest(ckpt_path)
    if kind == "drop_commit":
        return drop_commit(ckpt_path)
    if kind == "kill_writer":
        root = os.path.dirname(os.path.abspath(ckpt_path))
        name = os.path.basename(ckpt_path.rstrip(os.sep))
        step = int(name.split("_")[1].split(".")[0]) + 1
        return simulate_writer_kill(root, step, rng=rng)
    raise ValueError(f"not a checkpoint fault kind: {kind!r}")


def apply_fleet_event(event: FaultEvent, fleet) -> None:
    """Dispatch one fleet-fault event against a simulated fleet (anything
    exposing ``slow_host`` / ``hang_host`` / ``restore_host``)."""
    kind = event.kind
    if event.target is None:
        raise ValueError(f"fleet fault {kind!r} needs a target host")
    if kind == "slow_host":
        fleet.slow_host(event.target, event.arg if event.arg is not None else 4.0)
    elif kind == "hang_host":
        fleet.hang_host(event.target, event.arg if event.arg is not None else 1000.0)
    elif kind == "restore_host":
        fleet.restore_host(event.target)
    else:
        raise ValueError(f"not a fleet fault kind: {kind!r}")
