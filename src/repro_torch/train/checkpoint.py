"""Checkpointing: msgpack + zstd snapshots of a tree of tensors with an
async writer, the JAX package's ``train/checkpoint.py`` layout and format.

Layout: ``<dir>/step_<k>/shard_<i>.ckpt`` + ``meta.json`` + ``COMPLETE``. A
shard is a msgpack map from each leaf's path (``tree.tree_paths``) to its
dtype, shape and zstd-compressed bytes; a bf16 leaf is stored as its raw
16-bit patterns (a ``uint16`` view, as ``models/convert.py`` carries bf16)
under the dtype name ``bfloat16``. Writes go to a temporary name and are
renamed, so a crash mid-write never corrupts the latest snapshot;
``latest_step`` returns complete snapshots only. ``msgpack`` and
``zstandard`` are imported when a snapshot is written or read, never when
this module is. Without ``zstandard`` a leaf is stored in a zstd frame of
raw (uncompressed) blocks, which ``zstandard`` reads as any other frame,
and such frames are read back without it (:func:`zstd_stored`,
:func:`zstd_unstored`); a compressed frame still needs ``zstandard``.
"""
from __future__ import annotations

import importlib
import os
import re
import threading
import warnings
from typing import Any

import numpy as np
import torch

from ..obs.trace import dumps_strict
from ..tree import tree_map_with_path, tree_paths

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save", "zstd_stored", "zstd_unstored"]

_FLAG = "COMPLETE"


def _require(name: str):
    """Import an optional dependency of checkpointing, with a clear error."""
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            f"checkpointing requires the optional dependency {name!r}; install it to "
            "save or restore checkpoints"
        ) from e


_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_ZSTD_BLOCK = 1 << 17  # a block's largest size, 128 KiB


def zstd_stored(data: bytes) -> bytes:
    """``data`` as one zstd frame of raw blocks (RFC 8878): the content size
    in 8 bytes, a 128 KiB window, no checksum, no dictionary."""
    out = [_ZSTD_MAGIC, bytes([0xC0, 0x38]), len(data).to_bytes(8, "little")]
    view, pos = memoryview(data), 0
    while True:
        block = view[pos:pos + _ZSTD_BLOCK]
        pos += len(block)
        last = pos >= len(data)
        out += [((len(block) << 3) | last).to_bytes(3, "little"), block]  # type 0: raw
        if last:
            return b"".join(out)


def zstd_unstored(frame: bytes) -> bytes:
    """The content of one zstd frame of raw and RLE blocks (what
    :func:`zstd_stored` writes); a compressed block raises."""
    if frame[:4] != _ZSTD_MAGIC:
        raise ValueError("not a zstd frame")
    desc = frame[4]
    single = (desc >> 5) & 1
    pos = 5 + (not single) + (0, 1, 2, 4)[desc & 3] + (single, 2, 4, 8)[desc >> 6]
    out = []
    while True:
        head = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3
        kind, size = (head >> 1) & 3, head >> 3
        if kind == 0:
            out.append(frame[pos:pos + size])
            pos += size
        elif kind == 1:
            out.append(frame[pos:pos + 1] * size)
            pos += 1
        else:
            raise ModuleNotFoundError("this checkpoint's blocks are zstd-compressed: reading it "
                                      "requires the optional dependency 'zstandard'")
        if head & 1:
            return b"".join(out)


def _zstd():
    """(compress, decompress): ``zstandard``'s at level 3, else
    :func:`zstd_stored` and :func:`zstd_unstored`."""
    try:
        zstandard = importlib.import_module("zstandard")
    except ModuleNotFoundError:
        return zstd_stored, zstd_unstored
    return (lambda data: zstandard.compress(data, 3)), zstandard.decompress


def _to_numpy(t: torch.Tensor) -> tuple[str, np.ndarray]:
    t = t.detach().to("cpu", copy=True).contiguous()  # a copy, also of a host tensor
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return str(a.dtype), a


def _flatten(tree) -> dict[str, tuple[str, np.ndarray]]:
    """Each leaf's path to (dtype name, host array): a snapshot."""
    return {path: _to_numpy(t) for path, t in tree_paths(tree)}


def _write(directory: str, step: int, flat: dict, shard_id: int) -> str:
    (compress, _), msgpack = _zstd(), _require("msgpack")
    if compress is zstd_stored:  # shown once a process by the default filter
        warnings.warn("zstandard is not installed: checkpoint leaves are written uncompressed, "
                      "as zstd frames of raw blocks", stacklevel=2)
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    payload = {
        k: {"dtype": dt, "shape": list(a.shape),
            "data": compress(np.ascontiguousarray(a).tobytes())}
        for k, (dt, a) in flat.items()
    }
    tmp = os.path.join(d, f".shard_{shard_id}.tmp")
    final = os.path.join(d, f"shard_{shard_id}.ckpt")
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    os.replace(tmp, final)
    with open(os.path.join(d, "meta.json"), "w") as f:
        f.write(dumps_strict({"step": step, "n_leaves": len(flat)}))
    with open(os.path.join(d, _FLAG), "w") as f:
        f.write("ok")
    return final


def save(directory: str, step: int, tree: Any, *, shard_id: int = 0) -> str:
    """Blocking save of this host's shard; atomic via rename."""
    return _write(directory, step, _flatten(tree), shard_id)


def restore(directory: str, step: int, like: Any, *, shard_id: int = 0) -> Any:
    """Restore into the structure of ``like``: each leaf on its device, in
    its dtype, requiring a gradient where it does. A missing leaf or a shape
    mismatch raises (resharding goes through ``fault_tolerance.reshard_like``)."""
    (_, decompress), msgpack = _zstd(), _require("msgpack")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, f"shard_{shard_id}.ckpt"), "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    missing = {path for path, _ in tree_paths(like)} - set(payload)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")

    def load(path: str, ref: torch.Tensor) -> torch.Tensor:
        spec = payload[path]
        bf16 = spec["dtype"] == "bfloat16"
        arr = np.frombuffer(decompress(spec["data"]),
                            dtype=np.uint16 if bf16 else np.dtype(spec["dtype"]))
        arr = arr.reshape(spec["shape"])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {arr.shape} != expected {tuple(ref.shape)}")
        t = torch.from_numpy(arr.copy())
        t = t.view(torch.bfloat16) if bf16 else t
        return t.to(ref.device, ref.dtype).requires_grad_(ref.requires_grad)

    return tree_map_with_path(load, like)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, _FLAG)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class AsyncCheckpointer:
    """Saves on a writer thread: the tree is copied to the host on the
    caller's thread, then written; ``wait()`` joins the last write and raises
    its error (call it before exit and before restoring)."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree: Any, *, shard_id: int = 0) -> None:
        self.wait()
        flat = _flatten(tree)  # snapshot before the next step mutates the tree

        def _run():
            try:
                _write(self.directory, step, flat, shard_id)
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
