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
this module is.
"""
from __future__ import annotations

import importlib
import os
import re
import threading
from typing import Any

import numpy as np
import torch

from ..obs.trace import dumps_strict
from ..tree import tree_map_with_path, tree_paths

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]

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
    zstandard, msgpack = _require("zstandard"), _require("msgpack")
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    payload = {
        k: {"dtype": dt, "shape": list(a.shape),
            "data": zstandard.compress(np.ascontiguousarray(a).tobytes(), 3)}
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
    zstandard, msgpack = _require("zstandard"), _require("msgpack")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, f"shard_{shard_id}.ckpt"), "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    missing = {path for path, _ in tree_paths(like)} - set(payload)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")

    def load(path: str, ref: torch.Tensor) -> torch.Tensor:
        spec = payload[path]
        bf16 = spec["dtype"] == "bfloat16"
        arr = np.frombuffer(zstandard.decompress(spec["data"]),
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
