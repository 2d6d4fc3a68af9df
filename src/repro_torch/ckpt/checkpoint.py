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
"""
from __future__ import annotations

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


def save(directory: str, step: int, tree, blocking: bool = True
         ) -> Optional[threading.Thread]:
    """Save a tree of tensors; returns the writer thread if async."""
    leaves = [(k, *_host(v)) for k, v in T.leaves_with_paths(tree)]
    structure = _structure(tree)

    def write():
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

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "DONE")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, step: int, like) -> Any:
    """Restore into the structure of ``like``: new tensors, each on its
    ``like`` leaf's device and in its dtype.  A leaf whose saved shape
    differs from its ``like`` leaf's raises."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {entry["key"]: entry for entry in manifest["leaves"]}
    loaded = []
    for key, ref in T.leaves_with_paths(like):
        entry = by_key[key]
        arr = np.load(os.path.join(path, entry["file"]))
        if list(arr.shape) != list(ref.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                             f"expected {tuple(ref.shape)}")
        t = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
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
