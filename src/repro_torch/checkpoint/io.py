"""Atomic checkpoint serialization with verifiable manifests, for tensor trees.

Layout (format v2, the reference package's, byte for byte): one directory per
checkpoint (``step_00000123/``) containing one .npy per leaf plus
``manifest.json`` (tree skeleton, shapes, dtypes, per-leaf sha256 + CRC32 +
byte size, user metadata).  Writes go to a ``.tmp`` sibling and are
published with an atomic ``os.replace`` after a COMMIT marker — a crash
mid-write can never leave a readable-but-corrupt checkpoint, only a stale
``.tmp`` the resume scan quarantines.

Integrity is hashed **during** the write: every chunk numpy streams to disk
passes through a tee that updates sha256/CRC32 as it goes, so a multi-GB leaf
is never re-read (or held twice) just to fingerprint it.  The read side
mirrors that: :func:`validate_checkpoint` re-hashes leaf files in fixed-size
chunks — without ever deserializing an array — and raises
:class:`CheckpointCorrupt` with a machine-readable ``reason`` (the string the
quarantine layer writes into the corrupt checkpoint's reason file).

Leaves are tensors, numpy arrays or Python scalars.  A tensor is written from
its host copy as the numpy array of the same dtype; bfloat16, which numpy
has no native dtype for, is stored as a same-width unsigned view
(``"stored_dtype": "uint16"``) beside its logical ``"dtype"`` — the
reference's own layout, so a checkpoint written by either package restores
in the other with identical leaf files.  Loading gives every leaf back as a
tensor (a Python scalar as a 0-d tensor) on the requested device; a logical
dtype with no tensor counterpart raises.  Neither direction needs a numpy
dtype extension.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch

__all__ = [
    "CheckpointCorrupt",
    "checkpoint_nbytes",
    "load_checkpoint",
    "save_checkpoint",
    "validate_checkpoint",
]

_MANIFEST = "manifest.json"
_COMMIT = "COMMITTED"
#: chunk size for streamed verification reads (bounded peak memory per leaf)
_HASH_CHUNK = 1 << 20

#: dtypes that np.save/np.load roundtrip natively
_NUMPY_NATIVE = frozenset(
    np.dtype(t)
    for t in ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64", "float16", "float32", "float64",
              "complex64", "complex128")
)

#: tensor dtypes numpy lacks: logical name (as the reference's manifest
#: writes it) -> (torch dtype, same-width unsigned dtype it is stored as)
_BIT_CAST = {"bfloat16": (torch.bfloat16, torch.uint16)}
_BIT_CAST_BY_TORCH = {t: (name, stored) for name, (t, stored) in _BIT_CAST.items()}


def _skeleton(tree, leaves: list) -> Any:
    if isinstance(tree, dict):
        return {"__t": "dict", "items": {k: _skeleton(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__t": "tuple", "items": [_skeleton(v, leaves) for v in tree]}
    if isinstance(tree, list):
        return {"__t": "list", "items": [_skeleton(v, leaves) for v in tree]}
    if tree is None:
        return {"__t": "none"}
    idx = len(leaves)
    leaves.append(tree)
    return {"__t": "leaf", "idx": idx}


def _rebuild(skel, leaves):
    t = skel["__t"]
    if t == "dict":
        return {k: _rebuild(v, leaves) for k, v in skel["items"].items()}
    if t == "tuple":
        return tuple(_rebuild(v, leaves) for v in skel["items"])
    if t == "list":
        return [_rebuild(v, leaves) for v in skel["items"]]
    if t == "none":
        return None
    return leaves[skel["idx"]]


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, np.ndarray):
        return leaf.nbytes
    return 0


def checkpoint_nbytes(tree) -> int:
    """Payload bytes of the tensor and array leaves (scalars count 0, as the
    reference counts them)."""
    leaves: list = []
    _skeleton(tree, leaves)
    return sum(_leaf_nbytes(x) for x in leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(host array as stored on disk, logical dtype name).  A tensor goes out
    C-contiguous, as the reference's device arrays do; a numpy leaf as is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            raise ValueError(f"checkpoint leaves must be on the host, got {t.device} "
                             "(CheckpointManager snapshots devices before writing)")
        t = t.contiguous()
        cast = _BIT_CAST_BY_TORCH.get(t.dtype)
        if cast is not None:
            name, stored = cast
            return t.view(stored).numpy(), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype not in _NUMPY_NATIVE:
            raise TypeError(f"no checkpoint layout for numpy dtype {arr.dtype}")
    return arr, str(arr.dtype)


class _HashingWriter:
    """File-object tee: hashes every chunk ``np.save`` writes, as it writes.

    Not a real file object on purpose — numpy's ``isfileobj`` check fails for
    it, so ``write_array`` takes the buffered path and streams the array in
    bounded chunks through :meth:`write` instead of ``tofile``; sha256/CRC32
    therefore cover exactly the bytes on disk with no second read pass.
    """

    __slots__ = ("_f", "sha256", "crc32", "nbytes")

    def __init__(self, f) -> None:
        self._f = f
        self.sha256 = hashlib.sha256()
        self.crc32 = 0
        self.nbytes = 0

    def write(self, data) -> int:
        view = memoryview(data) if not isinstance(data, (bytes, bytearray)) else data
        self.sha256.update(view)
        self.crc32 = zlib.crc32(view, self.crc32)
        self.nbytes += len(view)
        return self._f.write(data)


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed validation.  ``reason`` is the machine-readable
    category (``missing_commit``, ``missing_manifest``, ``manifest_unreadable``,
    ``missing_leaf``, ``leaf_size_mismatch``, ``leaf_hash_mismatch``) used for
    quarantine reason files and the ``ckpt_validation_failures`` counter."""

    def __init__(self, message: str, reason: str = "corrupt") -> None:
        super().__init__(message)
        self.reason = reason


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    metadata: dict[str, Any] | None = None,
    fsync: bool = False,
) -> tuple[str, int]:
    """Write atomically; returns (final_path, bytes_written).

    ``tree`` leaves must already be on the host (the manager snapshots
    devices before calling, so device transfer is not hidden inside the
    write path).
    """
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves: list = []
    skel = _skeleton(tree, leaves)
    files = []
    total = 0
    for i, leaf in enumerate(leaves):
        arr, logical_dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        path = os.path.join(tmp, fname)
        with open(path, "wb") as f:
            tee = _HashingWriter(f)
            np.save(tee, arr)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        files.append(
            {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": logical_dtype,
                "stored_dtype": str(arr.dtype),
                "nbytes": tee.nbytes,
                "crc32": tee.crc32,
                "sha256": tee.sha256.hexdigest(),
            }
        )
        total += arr.nbytes
    manifest = {
        "step": step,
        "skeleton": skel,
        "leaves": files,
        "metadata": metadata or {},
        "format_version": 2,
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final, total


def _stream_digests(path: str) -> tuple[str, int, int]:
    """(sha256 hex, crc32, nbytes) of a file, read in bounded chunks."""
    sha = hashlib.sha256()
    crc = 0
    nbytes = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            sha.update(chunk)
            crc = zlib.crc32(chunk, crc)
            nbytes += len(chunk)
    return sha.hexdigest(), crc, nbytes


def validate_checkpoint(path: str) -> dict[str, Any]:
    """Structurally and cryptographically validate one checkpoint directory.

    Returns the parsed manifest on success.  Raises :class:`CheckpointCorrupt`
    (with ``reason`` set) the moment any check fails — commit marker, manifest
    presence/parse, leaf presence, byte size, then content hash.  No array is
    ever deserialized: a corrupt checkpoint is rejected *before* anything is
    loaded, and the streamed re-hash keeps peak memory at one chunk.
    """
    if not os.path.isdir(path):
        raise CheckpointCorrupt(f"{path}: not a checkpoint directory", "missing_directory")
    if not os.path.exists(os.path.join(path, _COMMIT)):
        raise CheckpointCorrupt(f"{path}: missing commit marker", "missing_commit")
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise CheckpointCorrupt(f"{path}: missing manifest", "missing_manifest")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        entries = manifest["leaves"]
        _ = manifest["skeleton"], manifest["step"]
    except (json.JSONDecodeError, KeyError, TypeError, UnicodeDecodeError) as exc:
        raise CheckpointCorrupt(
            f"{mpath}: unreadable manifest ({exc})", "manifest_unreadable"
        ) from exc
    for entry in entries:
        fpath = os.path.join(path, entry["file"])
        if not os.path.exists(fpath):
            raise CheckpointCorrupt(f"{fpath}: missing leaf file", "missing_leaf")
        expected_nbytes = entry.get("nbytes")
        if expected_nbytes is not None and os.path.getsize(fpath) != expected_nbytes:
            raise CheckpointCorrupt(
                f"{fpath}: size {os.path.getsize(fpath)} != manifest {expected_nbytes}",
                "leaf_size_mismatch",
            )
        sha, crc, _n = _stream_digests(fpath)
        expected_sha = entry.get("sha256")
        if expected_sha is not None:
            if sha != expected_sha:
                raise CheckpointCorrupt(f"{fpath}: sha256 mismatch", "leaf_hash_mismatch")
        elif crc != entry["crc32"]:  # format_version 1 fallback
            raise CheckpointCorrupt(f"{fpath}: CRC mismatch", "leaf_hash_mismatch")
    return manifest


def _to_tensor(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if str(arr.dtype) == logical_dtype:
        return t
    cast = _BIT_CAST.get(logical_dtype)
    if cast is None or t.dtype != cast[1]:
        raise TypeError(f"no tensor dtype for logical dtype {logical_dtype!r} "
                        f"stored as {arr.dtype}")
    return t.view(cast[0])


def load_checkpoint(
    path: str, device: str | torch.device | None = None, verify: bool = True,
    mmap: bool = False,
) -> tuple[int, Any, dict[str, Any]]:
    """Load one checkpoint directory. Returns (step, tree, metadata).

    Every leaf comes back as a tensor on ``device`` (the host when ``None``).
    With ``verify=True`` (default) the directory passes the full
    :func:`validate_checkpoint` gate *before* any ``np.load`` — corrupt data
    is never deserialized.  ``verify=False`` skips re-hashing for callers that
    just validated (e.g. the manager's resume path).  ``mmap`` maps each
    leaf's file copy-on-write instead of reading it: a caller that keeps a
    part of each leaf, as a process of a sharded or pipelined run does,
    reads only that part, and writes to a leaf never reach the file.
    """
    if verify:
        manifest = validate_checkpoint(path)
    else:
        if not os.path.exists(os.path.join(path, _COMMIT)):
            raise CheckpointCorrupt(f"{path}: missing commit marker", "missing_commit")
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    leaves = []
    for entry in manifest["leaves"]:
        arr = np.load(os.path.join(path, entry["file"]), mmap_mode="c" if mmap else None)
        t = _to_tensor(arr, entry["dtype"])
        leaves.append(t if device is None else t.to(device))
    tree = _rebuild(manifest["skeleton"], leaves)
    return manifest["step"], tree, manifest.get("metadata", {})
