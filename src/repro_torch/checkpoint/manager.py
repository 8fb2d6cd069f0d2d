"""Fault-tolerant checkpointing (the reference's ``checkpoint/manager.py``).

Guarantees:
  * atomicity -- a save writes ``<dir>/tmp.<step>.<pid>``, fsyncs its files
                 and a ``COMMITTED`` marker, then renames the directory to
                 ``step_<n>``; a crash mid-save never corrupts the latest
                 checkpoint, because "latest" scans committed directories only.
  * async     -- ``save(..., blocking=False)`` copies every leaf to host
                 memory before it returns, then writes on a background
                 thread; training goes on. The copy matters: the trainer
                 updates parameters in place, and on the CPU ``.cpu()`` and
                 ``.numpy()`` are views of the live tensors.
  * keep-N    -- older checkpoints are deleted after a successful commit.
  * one async save in flight at a time; ``wait()`` joins it and raises
    what the write raised.

A tree is nested dicts and lists whose leaves are tensors, numpy arrays or
Python numbers; each leaf is saved under its path ("params/stack/...").
npz cannot hold bfloat16, so a bf16 leaf is saved as its uint16 bits with
the dtype's name beside it, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common import map_leaves

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree) -> Tuple[List[str], list]:
    keys, leaves = [], []

    def visit(path, leaf):
        keys.append("/".join(str(k) for k in path))
        leaves.append(leaf)
    map_leaves(tree, visit)
    return keys, leaves


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` that later writes to the leaf cannot reach,
    and its dtype's name (bf16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.to("cpu", copy=True).numpy()
        return (a.view(np.uint16) if name == "bfloat16" else a), name
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, name: str, like):
    """The saved array as a leaf like ``like``: a tensor on its device with
    its dtype and ``requires_grad``, a numpy array, or a Python number."""
    if isinstance(like, torch.Tensor):
        if name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        t = t.to(device=like.device, dtype=like.dtype)
        return t.requires_grad_(like.requires_grad)
    if isinstance(like, np.ndarray):
        return a.astype(like.dtype)
    return type(like)(a.item())


def _write_fsynced(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _save_host(path: str, keys: List[str], arrays: List[np.ndarray],
               dtypes: List[str], extra: Dict) -> None:
    os.makedirs(path, exist_ok=True)
    _write_fsynced(os.path.join(path, "arrays.npz"), lambda f: np.savez(
        f, **{f"arr_{i}": a for i, a in enumerate(arrays)}))
    meta = {"keys": keys, "dtypes": dtypes, "extra": extra}
    _write_fsynced(os.path.join(path, "meta.json"),
                   lambda f: f.write(json.dumps(meta).encode()))


def save_pytree(path: str, tree, extra: Optional[Dict] = None) -> None:
    """Write ``tree`` (and the JSON ``extra``) into the directory ``path``."""
    keys, leaves = _flatten(tree)
    host = [_to_host(leaf) for leaf in leaves]
    _save_host(path, keys, [a for a, _ in host], [n for _, n in host], extra or {})


def load_pytree(path: str, like):
    """Restore into the structure of ``like``; returns (tree, extra)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        by_key = {k: (z[f"arr_{i}"], n)
                  for i, (k, n) in enumerate(zip(meta["keys"], meta["dtypes"]))}

    def restore(path_, like_leaf):
        key = "/".join(str(k) for k in path_)
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key}")
        return _from_host(*by_key[key], like_leaf)
    return map_leaves(like, restore), meta["extra"]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ query
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------- save
    def _write(self, step: int, keys, arrays, dtypes, extra: Dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        _save_host(tmp, keys, arrays, dtypes, extra)
        _write_fsynced(os.path.join(tmp, "COMMITTED"),
                       lambda f: f.write(str(time.time()).encode()))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _write_in_thread(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:                    # re-raised by wait()
            self._error = e

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def save(self, step: int, tree, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` to host memory now; write it on a background
        thread, or before returning with ``blocking``."""
        self.wait()                                   # one in-flight save at a time
        keys, leaves = _flatten(tree)
        host = [_to_host(leaf) for leaf in leaves]
        args = (step, keys, [a for a, _ in host], [n for _, n in host],
                dict(extra or {}, step=step))
        if blocking:
            self._write(*args)
        else:
            self._thread = threading.Thread(target=self._write_in_thread, args=args,
                                            daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    # ---------------------------------------------------------------- restore
    def restore(self, like, step: Optional[int] = None):
        """Returns (tree, extra), or (None, None) when no checkpoint exists."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_pytree(os.path.join(self.dir, f"step_{step}"), like)
