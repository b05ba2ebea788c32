"""Fault-tolerant checkpointing: atomic writes, keep-K, bitwise resume
(the port of :mod:`repro.checkpoint.manager`; the file format is the
same, so a checkpoint written by either package restores in the other).

Layout:  <dir>/step_<n>/
            arrays.npz        flattened pytree leaves ("/"-joined keys)
            meta.json         step, leaf treedef, mesh + config fingerprints

Writes go to ``step_<n>.tmp`` and are atomically renamed, so a job killed
mid-save never corrupts the restore point (the previous step remains
valid).  Every payload file is fsync'd before the rename and the parent
directory is fsync'd after it, so a *machine* crash (not just a process
kill) cannot publish a step whose bytes never reached disk; ``meta.json``
is written last and doubles as the completeness marker —
``all_steps``/``restore`` skip any step directory missing it or the
arrays payload.  ``restore`` returns leaves as numpy; the caller
moves them onto its device.  A ``torch.Tensor`` leaf is saved as
``leaf.detach().cpu().numpy()``, except a bf16 one: numpy has no bf16
(the JAX package gets it from ml_dtypes), so it is saved as the JAX
manager writes it — its raw 2-byte records under the descr ``'<V2'`` —
and restored as a CPU bf16 tensor wherever the ``like`` leaf is bf16.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager"]


# what np.savez writes for an ml_dtypes bfloat16 array (its ``dtype.str``);
# np.load reads it back as plain 2-byte records, ``|V2``
_BF16_DESCR = "<V2"


def _is_bf16_records(a: np.ndarray) -> bool:
    return a.dtype.kind == "V" and a.dtype.itemsize == 2 and a.dtype.names is None


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _from_numpy(a: np.ndarray, like):
    """A restored leaf; 2-byte records become bf16 where ``like`` is bf16."""
    if (isinstance(like, torch.Tensor) and like.dtype == torch.bfloat16
            and _is_bf16_records(a)):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _savez(f, flat: dict) -> None:
    """``np.savez(f, **flat)``, writing 2-byte records (bf16) under the
    descr the JAX package's ``np.savez`` gives a bf16 array."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if _is_bf16_records(a):
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": _BF16_DESCR, "fortran_order": False,
                        "shape": a.shape})
                    fid.write(np.ascontiguousarray(a).tobytes())
                else:
                    np.lib.format.write_array(fid, a, allow_pickle=False)


def _flatten(tree) -> dict:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}", v)
        else:
            flat[prefix] = _to_numpy(node)

    rec("", tree)
    return flat


def _unflatten(flat: dict, like):
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, tuple):
            kids = [rec(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            if hasattr(node, "_fields"):   # NamedTuple (e.g. OptState)
                return type(node)(*kids)
            return tuple(kids)
        if isinstance(node, list):
            return [rec(f"{prefix}/{i}", v) for i, v in enumerate(node)]
        return _from_numpy(flat[prefix], node)

    return rec("", like)


def _fsync_path(path: str) -> None:
    """fsync a file or directory; directory fsync is what makes the
    rename itself durable.  Best-effort on filesystems that refuse
    directory fds (some network mounts)."""
    flags = os.O_RDONLY | (os.O_DIRECTORY if os.path.isdir(path) else 0)
    try:
        fd = os.open(path, flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _complete(self, step: int) -> bool:
        d = self._step_dir(step)
        return (os.path.exists(os.path.join(d, "meta.json"))
                and os.path.exists(os.path.join(d, "arrays.npz")))

    def save(self, step: int, tree: Any, extra_meta: Optional[dict] = None) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(tree)
        # arrays first, meta last: meta.json is the completeness marker
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            _savez(f, flat)
            f.flush()
            os.fsync(f.fileno())
        meta = {"step": step, "n_leaves": len(flat)}
        meta.update(extra_meta or {})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _fsync_path(self.dir)  # make the rename itself durable
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self):
        """Published *complete* steps — a directory missing its payload
        or its meta marker (a crash artifact) is invisible to restore."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    step = int(name.split("_")[1])
                except ValueError:
                    continue
                if self._complete(step):
                    out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, dict]:
        """Restore into the structure of ``like``; returns (tree, meta)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return _unflatten(flat, like), meta
