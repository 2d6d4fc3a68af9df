"""Meshes over a ``torch.distributed`` world, the world itself, and the
bridge to the mesh-aware tuner — the port of the JAX package's
``launch/mesh.py``.

The JAX package forces host devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=8``) and runs one SPMD program
over them.  The port's counterpart is a world of processes, one per
rank, brought up by ``spawn``: each rank joins a process group through
a ``FileStore`` in a temporary directory (so that parallel test
workers never race for a TCP port), builds its ``DeviceMesh`` with
``make_host_mesh``, and runs the same program on its own shards.

On the CPU the backend is gloo.  On one card every rank uses
``cuda:0``: NCCL refuses two ranks on one device, so a one-card world
runs gloo too, which takes the card's tensors for most collectives and
stages the rest through host memory (``dist.collectives.via_host``).
The kernels always run on the card.  ``backend="nccl"`` is for a
machine with one card per rank.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..core.perf_model import V5E, MeshSpec
from ..dist.collectives import DryMesh
from ..dist.sharding import (Rules, batch_placement, default_rules,
                             dispatch_mesh_spec, feature_placement,
                             mesh_shape, ring_dispatch_spec)


def make_production_mesh(*, multi_pod: bool = False) -> DryMesh:
    """The JAX package's production mesh, 16 x 16 ``("data", "model")``
    (one pod) or 2 x 16 x 16 ``("pod", "data", "model")``, as seen from
    rank 0 without a world: a ``DryMesh``, whose collectives move
    nothing (``launch.dryrun`` traces one rank's step on it)."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return DryMesh(shape)


def make_host_mesh(model_axis: int = 1, pods: Optional[int] = None):
    """The ("data", "model") DeviceMesh over the initialised world:
    ``world // model_axis`` x ``model_axis`` ranks, row-major; with
    ``pods``, the ("pod", "data", "model") one of the JAX package's
    multi-pod production mesh: ``pods`` x ``world // (pods *
    model_axis)`` x ``model_axis``."""
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    per = model_axis * (pods or 1)
    if n % per:
        raise ValueError(f"model axis {model_axis} x {pods or 1} pods does "
                         f"not divide the world of {n}")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if pods is None:
        return DeviceMesh(dev, torch.arange(n).reshape(n // model_axis,
                                                       model_axis),
                          mesh_dim_names=("data", "model"))
    return DeviceMesh(dev, torch.arange(n).reshape(pods, n // per,
                                                   model_axis),
                      mesh_dim_names=("pod", "data", "model"))


def tuner_mesh_spec(mesh, rules: Optional[Rules] = None, *,
                    kind: str = "gemm", batch: Optional[int] = None,
                    feature_dim: Optional[int] = None,
                    reduction_dim: Optional[int] = None,
                    shard_reduction: bool = False,
                    ici_bw: float = V5E.ici_bw) -> MeshSpec:
    """The MeshSpec for tuning fused kernels under this mesh and
    regime, built by the same helpers ``kernels.ops`` dispatches with.

    * ``kind="gemm"``: the batch rides the data dims; the ``h`` loop
      rides tp-or-model (``feature_dim`` is H).
    * ``kind="attention"``: heads fold into the chain batch, so
      tp-or-model joins ``batch_axes`` (``feature_dim`` is the kv-head
      count).
    * ``shard_reduction=True``: the ``n`` loop (the kv sequence) rides
      tp-or-model, gated by ``reduction_dim`` — the ring regime.

    Concrete dims (``batch`` and the feature or reduction dim) apply
    the dispatcher's divisibility; omitted dims are taken to divide."""
    if kind not in ("gemm", "attention"):
        raise ValueError(f"unknown chain kind {kind!r}")
    rules = rules if rules is not None else default_rules(mesh)
    if shard_reduction and batch is not None and reduction_dim is not None:
        return ring_dispatch_spec(rules, mesh, batch=batch,
                                  kv_len=reduction_dim, ici_bw=ici_bw)[0]
    if not shard_reduction and batch is not None \
            and feature_dim is not None:
        return dispatch_mesh_spec(rules, mesh, kind=kind, batch=batch,
                                  feature_dims=(feature_dim,),
                                  ici_bw=ici_bw)[0]
    shape = mesh_shape(mesh)
    if batch is not None:
        baxes = batch_placement(rules, mesh, batch)
    else:
        baxes = tuple(a for a in (rules.batch_axes or rules.data)
                      if a in shape and shape[a] > 1)

    def _tp_axis(dim: Optional[int]) -> Optional[str]:
        if dim is not None:
            return feature_placement(rules, mesh, dim, taken=baxes)
        ax = rules.tp or rules.model
        if ax and ax not in baxes and ax in shape and shape[ax] > 1:
            return ax
        return None

    placement: tuple[tuple[str, str], ...] = ()
    if shard_reduction:
        red = _tp_axis(reduction_dim)
        if red:
            placement = (("n", red),)
    else:
        feat = _tp_axis(feature_dim)
        if feat:
            if kind == "attention":
                baxes = baxes + (feat,)
            else:
                placement = (("h", feat),)
    return MeshSpec.from_mesh(mesh, placement=placement, batch_axes=baxes,
                              ici_bw=ici_bw)


# ---------------------------------------------------------------------------
# the world: one process per rank
# ---------------------------------------------------------------------------

def init_rank(rank: int, world: int, store_path: str, *,
              backend: str = "gloo", device: str = "cpu",
              timeout_s: float = 600.0) -> None:
    """Join the world as ``rank``: the process group over a FileStore
    at ``store_path``, this rank's device (every rank shares the cards
    round-robin — one card: all on ``cuda:0``), and CPU threads split
    between the ranks."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank, world, tmp, backend, device, out):
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        init_rank(rank, world, os.path.join(tmp, "store"), backend=backend,
                  device=device)
        result = fn(rank, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, backend: str = "gloo",
          device: str = "cpu", timeout_s: float = 900.0) -> list:
    """Run ``fn(rank, *args)`` on ``world`` spawned ranks joined in one
    process group; returns the ranks' results in rank order.  ``fn``
    must be importable by name (a module-level function) and its
    results picklable.  A rank that raises or dies, or a world that
    outlives ``timeout_s``, stops every rank and raises here with the
    failing rank's traceback."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="world-") as tmp:
        # the call goes through a file: a process's start blocks until
        # the child reads its arguments, so large ones passed directly
        # would start the ranks one after another
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, tmp, backend, device, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        results: dict[int, object] = {}
        error = None
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world and error is None:
                try:
                    rank, ok, res = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and i not in results]
                    if dead:
                        error = (f"rank {dead[0]} died with exit code "
                                 f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        error = f"the world outlived {timeout_s} s"
                    continue
                if ok:
                    results[rank] = res
                else:
                    error = f"rank {rank} failed:\n{res}"
        finally:
            for p in procs:
                p.join(timeout=5.0 if error is None else 1.0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
        if error is not None:
            raise RuntimeError(error)
        return [results[r] for r in range(world)]
