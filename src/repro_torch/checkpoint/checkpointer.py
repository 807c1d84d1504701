"""Async, atomic checkpointing: the JAX package's ``checkpoint/checkpointer.py``
on trees of tensors.

Layout (the reference's, so either package restores the other's files):
    <dir>/step_00000123.tmp-<nonce>/   files being written
    <dir>/step_00000123/               atomically renamed when complete
        meta.json                      step, leaf count, shapes, dtypes
        arrays.npz                     leaf_0 .. leaf_{n-1}

Leaves are numbered in ``jax.tree_util``'s order (dict keys sorted, lists,
tuples and NamedTuples in order); bf16 is widened to fp32 on disk.
``save()`` copies the tree to host memory at once and writes it on a
background thread; ``restore()`` rebuilds ``like``'s structure with every
tensor leaf on ``like``'s device and in its dtype.  The newest ``keep``
checkpoints stay; older ones go only after a newer one is durable.

Sharded trees: ``save()`` of a tree with ``DTensor`` leaves writes full
tensors (every rank gathers each leaf with ``full_tensor()``, rank 0
writes), so the file does not care what mesh wrote it; ``restore(step,
like, shardings=(specs, mesh))`` lays each restored leaf out on the current
mesh by its spec (``parallel.sharding.place``: each rank keeps its slices
of the saved tensor), the reference's cross-topology reshard.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import uuid
from typing import Any

import numpy as np
import torch

from ..utils.tree import tree_flatten, tree_unflatten


@dataclasses.dataclass
class CheckpointSpec:
    directory: str
    keep: int = 3


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp" not in name:
            try:
                steps.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return max(steps) if steps else None


def _is_dtensor(leaf: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _to_host(leaf: Any) -> np.ndarray:
    """A host copy of one leaf, bf16 widened to fp32 (npz holds no bf16);
    a ``DTensor`` is gathered whole first (a collective: every rank)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.cpu())
    a = np.array(leaf)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


class Checkpointer:
    def __init__(self, spec: CheckpointSpec):
        self.spec = spec
        os.makedirs(spec.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot now, write in the background (async checkpointing).
        A tree with ``DTensor`` leaves is saved by every rank of their
        mesh together; rank 0 writes."""
        self.wait()  # only one in-flight save
        leaves, spec = tree_flatten(tree)
        host = [_to_host(leaf) for leaf in leaves]
        if any(map(_is_dtensor, leaves)) and torch.distributed.get_rank():
            return

        def write():
            try:
                self._write(step, host, spec)
            except Exception as e:                      # pragma: no cover
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, leaves: list[np.ndarray], spec: Any) -> None:
        d = self.spec.directory
        final = os.path.join(d, f"step_{step:08d}")
        tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
        meta = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": repr(spec),
            "shapes": [list(leaf.shape) for leaf in leaves],
            "dtypes": [str(leaf.dtype) for leaf in leaves],
            "time": time.time(),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(tmp)       # concurrent writer already won
        else:
            os.replace(tmp, final)   # atomic publish
        self._gc()

    def _gc(self) -> None:
        d = self.spec.directory
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(d)
            if n.startswith("step_") and ".tmp" not in n)
        for s in steps[: -self.spec.keep]:
            shutil.rmtree(os.path.join(d, f"step_{s:08d}"), ignore_errors=True)
        # orphaned tmp dirs from crashes
        for n in os.listdir(d):
            if ".tmp-" in n:
                age = time.time() - os.path.getmtime(os.path.join(d, n))
                if age > 3600:
                    shutil.rmtree(os.path.join(d, n), ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Rebuild ``like``'s tree from checkpoint ``step``: a tensor leaf of
        ``like`` gives a tensor on its device in its dtype, any other leaf a
        numpy array in ``np.asarray(leaf)``'s dtype.  ``shardings = (specs,
        mesh)``, a spec tree like ``like`` and a ``DeviceMesh``, makes every
        leaf a ``DTensor`` laid out by its spec (cross-topology reshard:
        the checkpoint does not care what mesh wrote it)."""
        d = os.path.join(self.spec.directory, f"step_{step:08d}")
        leaves_like, spec = tree_flatten(like)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            loaded = [data[f"leaf_{i}"] for i in range(len(leaves_like))]
        restored = []
        for arr, ref in zip(loaded, leaves_like):
            if isinstance(ref, torch.Tensor):
                restored.append(torch.from_numpy(np.array(arr)).to(
                    device=ref.device, dtype=ref.dtype))
            else:
                restored.append(np.asarray(arr).astype(np.asarray(ref).dtype))
        tree = tree_unflatten(spec, restored)
        if shardings is not None:
            from ..parallel.sharding import place_tree
            specs, mesh = shardings
            tree = place_tree(tree, specs, mesh)
        return tree
