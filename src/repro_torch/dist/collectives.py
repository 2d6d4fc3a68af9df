"""The explicit collectives of the port's mesh execution.

The JAX package's mesh programs are SPMD: XLA inserts an all-reduce, an
all-gather or a collective-permute wherever a layout changes.  Here
each rank runs its own eager program over its local shards, and the
model and the ring regimes call these functions at those places.

``Axis`` is one rank's view of one mesh dim: its size, its index along
it, its process group.  Every collective runs in that group through
``torch.distributed``.  Backends differ in which tensors they take:
NCCL takes CUDA tensors for every op; gloo takes CUDA tensors for
``all_reduce``, ``broadcast`` and ``all_gather`` (it stages them
through host memory itself) but not for ``send``/``recv``, which read
the tensor's pointer as host memory.  Those ops go through
``via_host``, the one function that moves a tensor through host
memory, and it counts each such hop in ``HOST_HOPS``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .sharding import mesh_shape

#: ops whose tensors gloo cannot take on the card
GLOO_HOST_OPS = frozenset({"send", "recv"})

#: tensors moved through host memory by ``via_host``, by op: the count
#: and the bytes
HOST_HOPS: dict[str, list] = {}


def via_host(op: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host for an op the backend cannot run on the card's
    memory (``GLOO_HOST_OPS`` under gloo), counted in ``HOST_HOPS``;
    ``t`` itself otherwise."""
    if not (t.is_cuda and op in GLOO_HOST_OPS
            and dist.get_backend() == "gloo"):
        return t
    rec = HOST_HOPS.setdefault(op, [0, 0])
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()
    return t.cpu()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One rank's place on one mesh dim."""

    names: tuple[str, ...]
    size: int
    index: int
    group: object            # torch.distributed ProcessGroup
    ranks: tuple[int, ...]   # global ranks along the dim, by index

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``) over the dim, out of place."""
        if self.size == 1:
            return x
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return y

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, by index."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {self.names} ({self.size})")
        step = n // self.size
        return x.narrow(dim, self.index * step, step)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """One hop of a ring: send ``x`` to the next rank along the dim
        and return what the previous one sent (the JAX package's
        ``ppermute`` with ``perm = [(i, i + 1 mod n)]``)."""
        if self.size == 1:
            return x
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        out = via_host("send", x.contiguous())
        buf = via_host("recv", torch.empty_like(x))
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, nxt, self.group),
            dist.P2POp(dist.irecv, buf, prv, self.group)])
        for r in reqs:
            r.wait()
        return buf.to(x.device)


def axis(mesh, names) -> Optional[Axis]:
    """This rank's ``Axis`` over the mesh dim(s) ``names`` (a name or a
    tuple of names), or None for no dim or dims of size 1.  Several dims
    of size > 1 at once (a batch over data and model) are not run."""
    if mesh is None or not names:
        return None
    shape = mesh_shape(mesh)
    names = tuple(n for n in ((names,) if isinstance(names, str) else names)
                  if shape[n] > 1)
    if not names:
        return None
    if len(names) > 1:
        raise NotImplementedError(f"a collective over the mesh dims {names}")
    group = mesh.get_group(names[0])
    return Axis(names, shape[names[0]], mesh.get_local_rank(names[0]), group,
                tuple(dist.get_process_group_ranks(group)))


def gather_dims(t: torch.Tensor, layout: Sequence, mesh,
                keep: tuple[str, ...] = ()) -> torch.Tensor:
    """``t`` (a local shard laid out as ``layout``) gathered whole
    along every dim sharded over a mesh dim not in ``keep`` — the FSDP
    gather of a weight before its use."""
    for d, entry in enumerate(layout):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        names = tuple(n for n in names if n not in keep)
        for n in reversed(names):
            ax = axis(mesh, n)
            if ax is not None:
                t = ax.all_gather(t, d)
    return t


def shard_dims(t: torch.Tensor, layout: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` laid out as
    ``layout`` (dims over several mesh dims split row-major), copied
    out of ``t`` so that the whole may be freed (a block of leading
    rows is a view that would keep all of ``t`` alive)."""
    block = t
    for d, entry in enumerate(layout):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        for n in names:
            ax = axis(mesh, n)
            if ax is not None:
                block = ax.shard(block, d)
    return block if block is t else block.clone(
        memory_format=torch.contiguous_format)
