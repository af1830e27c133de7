"""Checkpointing: atomic, async-capable, in the JAX package's format.

* Atomic: write to ``<dir>/.tmp.<step>`` then ``os.replace`` — a killed
  writer never corrupts the latest checkpoint (fault tolerance).
* Async: a single background thread drains a queue of (step, host-copy)
  snapshots so the train loop never blocks on disk.
* Portable: the files are the JAX package's (``checkpoint/checkpoint.py``
  there), so a checkpoint written by either package restores in the
  other.

Format: one ``.npz`` per checkpoint with flattened path->array entries
(paths of ``utils/tree.py``: sorted dict keys and NamedTuple fields
joined by ``/``; a bf16 leaf stored as ``"bf16::" + path`` in a uint16
view), plus a tiny JSON manifest (step, path).
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.tree import (flatten_with_paths, tree_map,
                                    tree_map_with_path)


def _to_numpy_tree(tree) -> Dict[str, np.ndarray]:
    out = {}
    for path, leaf in flatten_with_paths(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            out["bf16::" + path] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            out[path] = t.numpy()
    return out


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Blocking atomic save. Returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _to_numpy_tree(tree)
    tmp = os.path.join(ckpt_dir, f".tmp.{step}.npz")
    final = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    manifest = {"step": step, "path": final}
    mtmp = os.path.join(ckpt_dir, ".manifest.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, "manifest.json"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    ckpts = sorted(
        f for f in os.listdir(ckpt_dir)
        if f.startswith("ckpt_") and f.endswith(".npz"))
    for f in ckpts[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f))
        except OSError:
            pass


def latest_step(ckpt_dir: str) -> Optional[int]:
    mf = os.path.join(ckpt_dir, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["step"]


def _from_numpy(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")
    if bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, template, step: Optional[int] = None,
            device=None, shardings: Any = None):
    """Restore into the structure of ``template`` (a tree of tensors;
    ``device="meta"`` ones will do).  Each leaf takes its template's
    dtype and goes to ``device``, or, when that is None, to its
    template's device.  Returns (tree, step).

    ``shardings``: one ``launch.sharding.NamedSharding`` (a mesh and a
    spec) for every leaf, or a tree of them like ``template`` — the
    elastic-resume path: each leaf is distributed over its mesh
    (``distribute_tensor``, from rank 0's copy) as a DTensor, so a
    checkpoint saved without a mesh, or on another, resumes onto any
    mesh.  Every rank of the mesh must call it."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        by_path = {}
        for k in data.files:
            if k.startswith("bf16::"):
                by_path[k[len("bf16::"):]] = _from_numpy(data[k], True)
            else:
                by_path[k] = _from_numpy(data[k], False)

    shard_of = None
    if shardings is not None:
        if hasattr(shardings, "placements"):
            shard_of = {p: shardings for p, _ in flatten_with_paths(template)}
        else:
            shard_of = dict(flatten_with_paths(shardings))

    def leaf(p, tmpl):
        if p not in by_path:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = by_path[p]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"shape mismatch for {p}: ckpt {tuple(arr.shape)} vs "
                f"template {tuple(tmpl.shape)}")
        if shard_of is not None:
            from torch.distributed.tensor import distribute_tensor
            sh = shard_of[p]
            return distribute_tensor(arr.to(dtype=tmpl.dtype), sh.mesh,
                                     sh.placements)
        return arr.to(device=tmpl.device if device is None else device,
                      dtype=tmpl.dtype)
    return tree_map_with_path(leaf, template), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer with bounded queue."""

    def __init__(self, ckpt_dir: str, keep: int = 3, max_pending: int = 2):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save(self.ckpt_dir, step, tree, keep=self.keep)
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree):
        """Snapshot to host memory now; write in background."""
        if self._err is not None:
            raise self._err
        host_tree = tree_map(
            lambda x: torch.as_tensor(x).detach().to("cpu", copy=True), tree)
        self._q.put((step, host_tree))

    def wait(self):
        self._q.join()
        if self._err is not None:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
