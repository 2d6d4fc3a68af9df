"""Atomic, resumable checkpointing of a tree of tensors — the port of
the JAX package's ``repro.ckpt.checkpoint``, with its layout:

    <dir>/step_<N>/
            manifest.json           step, tree structure, and per leaf
                                    its path key, file, shape and dtype
            arr_<i>.npy             one file per leaf (copied to the host)
            DONE                    commit marker (atomic rename)

Writes go to a tmp dir first and are renamed into place, so a crash
mid-save never corrupts the latest checkpoint; ``latest_step`` only
considers committed (DONE-marked) steps.  An async mode runs the write
on a background thread off the critical path; every leaf is copied to
the host before the thread starts, so the caller may go on updating
its tensors in place.

numpy has no bfloat16: a bf16 leaf is written as its raw 16 bits
(int16) with ``"dtype": "bfloat16"`` in the manifest, and restored bit
for bit.

A sharded state (each rank of a ``torch.distributed`` world holding its
blocks, laid out as ``layouts`` on ``mesh``: a tree of layouts mirroring
the state's) is saved gathered whole, as the JAX package's host-gathered
arrays are, and written once, by rank 0; every rank waits for the
write.  A restore onto a mesh reads the whole leaves and gives each rank
its blocks of them, on whatever mesh it is given: the re-shard of an
elastic restart.  ``restore`` without a ``like`` tree returns the saved
tree whole on the host.
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import tree as T


def _structure(tree) -> str:
    """The tree's nesting with ``*`` for each leaf (the manifest's
    counterpart of the JAX package's printed treedef)."""
    return str(T.map_tree(lambda _: "*", tree))


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and the dtype name the manifest records."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy(), "bfloat16"
    arr = t.to("cpu", copy=True).numpy()
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree, blocking: bool = True,
         layouts=None, mesh=None) -> Optional[threading.Thread]:
    """Save a tree of tensors; returns the writer thread if async.  On a
    ``mesh`` the leaves are this rank's blocks laid out as ``layouts``:
    each is gathered whole, rank 0 writes, and every rank returns after
    the write (an async save on a mesh raises)."""
    if mesh is not None:
        if not blocking:
            raise ValueError("a sharded state is saved blocking: every "
                             "rank waits for rank 0's write")
        import torch.distributed as dist

        from ..dist.collectives import gather_dims
        write0 = dist.get_rank() == 0
        leaves = []
        with torch.no_grad():
            for (k, v), lay in zip(T.leaves_with_paths(tree),
                                   T.leaves(layouts, like=tree)):
                whole = gather_dims(v, lay, mesh)
                if write0:
                    leaves.append((k, *_host(whole)))
                del whole
        if write0:
            _write(directory, step, leaves, _structure(tree))
        dist.barrier()
        return None
    leaves = [(k, *_host(v)) for k, v in T.leaves_with_paths(tree)]
    structure = _structure(tree)
    if blocking:
        _write(directory, step, leaves, structure)
        return None
    t = threading.Thread(target=_write,
                         args=(directory, step, leaves, structure),
                         daemon=True)
    t.start()
    return t


def _write(directory: str, step: int, leaves: list, structure: str) -> None:
    """The step's files into a tmp dir, renamed into place."""
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": structure, "leaves": []}
    for i, (key, arr, dtype) in enumerate(leaves):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest["leaves"].append(
            {"key": key, "file": f"arr_{i}.npy",
             "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "DONE")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, entry: dict) -> torch.Tensor:
    t = torch.from_numpy(np.load(os.path.join(path, entry["file"])))
    return t.view(torch.bfloat16) if entry["dtype"] == "bfloat16" else t


def restore(directory: str, step: int, like=None, layouts=None,
            mesh=None) -> Any:
    """Restore into the structure of ``like``: new tensors, each on its
    ``like`` leaf's device and in its dtype.  A leaf whose saved shape
    differs from its ``like`` leaf's raises.  On a ``mesh`` the ``like``
    leaves are this rank's blocks laid out as ``layouts`` (a tree
    mirroring ``like``): each whole leaf read is cut to the rank's
    block (``collectives.shard_dims``).  Without ``like``: the saved
    tree, whole, each leaf on the host in its saved dtype."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if like is None:
        leaves = iter([_load(path, e) for e in manifest["leaves"]])
        return T.map_tree(lambda _: next(leaves),
                          ast.literal_eval(manifest["treedef"]))
    by_key = {entry["key"]: entry for entry in manifest["leaves"]}
    flat = (T.leaves(layouts, like=like) if mesh is not None
            else [None] * len(T.leaves(like)))
    loaded = []
    for (key, ref), lay in zip(T.leaves_with_paths(like), flat):
        t = _load(path, by_key[key])
        if mesh is not None:
            from ..dist.collectives import shard_dims
            t = shard_dims(t, lay, mesh)
        if list(t.shape) != list(ref.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {tuple(t.shape)}"
                             f", expected {tuple(ref.shape)}")
        loaded.append(t.to(device=ref.device, dtype=ref.dtype))
    leaves = iter(loaded)
    return T.map_tree(lambda _: next(leaves), like)


def prune_old(directory: str, keep: int = 2) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(s for s in (
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
