"""Manifest-committed checkpointing, PyTorch port of
``repro.checkpoint.manager``, in the JAX package's layout byte for byte,
so that a checkpoint written by either package restores into the other.

Layout (one directory per step):

  <root>/step_000042.tmp/      # written first
    leaf_00000.npy ...         # one file per tree leaf
    manifest.json              # names, shapes, dtypes, step; written last
  <root>/step_000042/          # atomic rename after the manifest's fsync

Leaves are numbered in ``jax.tree.flatten`` order (dict keys sorted,
depth first) and named as ``jax.tree_util.keystr`` writes their paths
(``['params']['layers']['wq']``).  bfloat16 leaves are stored as their
raw ``uint16`` bits with the logical dtype in the manifest.  Restore is
positional, like the JAX package's: the i-th file fills the i-th leaf of
``like``, so the order is part of the format.

Crash safety: a checkpoint exists iff the final rename happened; partial
writes are invisible (".tmp" dirs are garbage-collected on open).

Async: ``CheckpointManager.save(..., blocking=False)`` copies every leaf
to host memory before it returns (the port's optimizer updates its
tensors in place, so a deferred copy would catch the next step's
values) and writes the files on a background thread; ``wait()`` joins.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import check_sharding


def _flatten_with_names(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr name, leaf) pairs in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_names(tree[k], f"{path}[{k!r}]")]
    return [(path, tree)]


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def _check_shardings(like, shardings, path: str = "") -> None:
    """``shardings`` has ``like``'s keys, and each of its shardings fits
    the leaf of ``like`` it stands for."""
    if isinstance(like, dict) or isinstance(shardings, dict):
        if not (isinstance(like, dict) and isinstance(shardings, dict)
                and set(like) == set(shardings)):
            raise ValueError(f"restore: shardings{path} does not match the "
                             f"tree restored into")
        for k in sorted(like):
            _check_shardings(like[k], shardings[k], f"{path}[{k!r}]")
        return
    check_sharding(shardings, tuple(like.shape), f"restore: {path}")


def _host(leaf: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``leaf`` that later in-place updates do not touch."""
    return leaf.detach().to("cpu", copy=True)


def _npy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name) of a CPU tensor."""
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = leaf.numpy()
    return arr, str(arr.dtype)


def save(path: os.PathLike, tree: Any, step: int,
         extra: Optional[dict] = None) -> pathlib.Path:
    """Blocking save with atomic commit."""
    root = pathlib.Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        if leaf.device.type != "cpu":
            leaf = _host(leaf)
        arr, logical_dtype = _npy(leaf.detach())
        fn = f"leaf_{i:05d}.npy"
        np.save(tmp / fn, arr)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape),
             "dtype": logical_dtype})
    mpath = tmp / "manifest.json"
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(path: os.PathLike) -> Optional[int]:
    root = pathlib.Path(path)
    if not root.exists():
        return None
    # GC partial writes
    for tmp in root.glob("step_*.tmp"):
        shutil.rmtree(tmp, ignore_errors=True)
    steps = sorted(int(p.name.split("_")[1])
                   for p in root.glob("step_*") if p.is_dir()
                   and (p / "manifest.json").exists())
    return steps[-1] if steps else None


def restore(path: os.PathLike, like: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf takes ``like``'s dtype and device.  ``shardings`` (optional,
    a tree of ``parallel.sharding.Sharding`` matching ``like``) is the
    elastic-restart path's layout on the *current* mesh, which may
    differ from the saved one's: it must have ``like``'s keys, and every
    spec's axes must be in its mesh and divide the leaf's dims
    (``ValueError`` otherwise, as re-sharding onto the mesh would fail).
    The mesh is logical on the port's one card, so the leaves are then
    loaded whole onto ``like``'s device: their values are what was
    saved, whatever the mesh.  Returns (tree, step, extra)."""
    if shardings is not None:
        _check_shardings(like, shardings)
    root = pathlib.Path(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    named = _flatten_with_names(like)
    assert len(named) == len(manifest["leaves"]), \
        f"checkpoint has {len(manifest['leaves'])} leaves, " \
        f"expected {len(named)}"
    out = []
    for rec, (_, leaf) in zip(manifest["leaves"], named):
        arr = np.load(d / rec["file"])
        if rec["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{rec['name']}: shape {tuple(t.shape)} != "
                f"{tuple(leaf.shape)}")
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return _unflatten(like, out), manifest["step"], manifest["extra"]


class CheckpointManager:
    """Async writer + retention policy."""

    def __init__(self, path: os.PathLike, keep: int = 3):
        self.path = pathlib.Path(path)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: list = []

    def save(self, tree: Any, step: int, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        # copy to host now: the optimizer updates these tensors in place
        names = _flatten_with_names(tree)
        host_tree = _unflatten(tree, [_host(leaf) for _, leaf in names])

        def work():
            save(self.path, host_tree, step, extra)
            self.saved_steps.append(step)
            self._retain()

        self.wait()
        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _retain(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.path.glob("step_*") if p.is_dir())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.path / f"step_{s:08d}",
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any, shardings: Any = None):
        self.wait()
        return restore(self.path, like, shardings=shardings)
