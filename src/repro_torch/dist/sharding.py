"""Logical-axis sharding rules — the port of the JAX package's
``dist/sharding.py`` for a ``torch.distributed`` mesh.

Model code names tensor dims with *logical* axes; a ``Rules`` instance
maps them onto the mesh dims of a
``torch.distributed.device_mesh.DeviceMesh`` (dims ``("data",
"model")``, ``launch.mesh.make_host_mesh``):

    weight layouts (``Rules.spec``):
        "data"   -> the FSDP axes (``rules.data``); None when
                    ``fsdp=False`` (resident TP weights)
        "model"  -> the tensor-parallel mesh dim
        "tp"     -> the activation tensor-parallel mesh dim
        None     -> replicated

    activations (``constrain``, ``local_shape``):
        "batch"  -> ``rules.batch_axes or rules.data`` (dropping axes
                    that do not divide the dim)
        "seq"    -> ``rules.seq``
        "tp"     -> ``rules.tp``
        None     -> whole on every rank

A **layout** is the port's own type: a tuple with one entry per tensor
dim, each a mesh-dim name, a tuple of names, or None.  The JAX package
returns ``PartitionSpec`` objects and its callers index them
(``lead[0] if len(lead) else None``); the port returns plain tuples
instead — ``batch_spec`` gives the batch dim's entry itself — so that
no caller depends on ``PartitionSpec`` indexing.

The JAX package is SPMD: one program over sharded arrays, with XLA
inserting the collectives at every ``with_sharding_constraint``.  Here
each rank holds its local shards as plain tensors, so ``constrain``
checks a local tensor against the shape its layout implies, and the
model runs an explicit collective (``dist.collectives``) at each place
where the reference's layout changes: the vocab-parallel embedding and
logits, the row-parallel ``wo``/``w_down`` products, the kv heads a
model axis cannot divide, a sequence-sharded cache, and the combines of
the ring regimes.

A mesh here is anything with ``mesh_dim_names`` and a ``shape`` tuple
(a DeviceMesh), or with a ``shape`` mapping from names to sizes (a
stand-in for tests): ``mesh_shape`` reads either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

AxisName = Union[str, Sequence[str], None]

_LOGICAL_AXES = (None, "batch", "seq", "tp", "model", "data")


def mesh_shape(mesh) -> dict[str, int]:
    """{mesh dim name: size}, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _as_tuple(axes: AxisName) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Mapping from logical tensor axes to physical mesh dims.

    data:       mesh dims carrying data parallelism; also the FSDP
                weight-sharding dims while ``fsdp`` is True.
    model:      mesh dim of the tensor-parallel weight shards.
    tp:         mesh dim of activation tensor parallelism (None: the
                weights gather, activations stay whole on every rank).
    seq:        mesh dim of sequence parallelism, or None.
    batch_axes: override for the batch dim's placement; defaults to
                ``data``.
    fsdp:       when False, "data" in weight layouts resolves to None
                so the TP weight shards stay resident (decode regime).
    """

    data: tuple[str, ...] = ()
    model: Optional[str] = None
    tp: Optional[str] = None
    seq: Optional[str] = None
    batch_axes: Optional[tuple[str, ...]] = None
    fsdp: bool = True

    @classmethod
    def disabled(cls) -> "Rules":
        """Rules under which every layout is whole on every rank and
        ``constrain`` is the identity (single-device execution)."""
        return cls()

    @property
    def enabled(self) -> bool:
        return bool(self.data) or self.model is not None

    def _resolve(self, name: Optional[str]) -> AxisName:
        if name is None:
            return None
        if name == "data":
            return (self.data or None) if self.fsdp else None
        if name == "model":
            return self.model
        if name == "tp":
            return self.tp
        if name == "seq":
            return self.seq
        if name == "batch":
            return tuple(self.batch_axes or self.data) or None
        raise ValueError(f"unknown logical axis {name!r}; expected one of "
                         f"{_LOGICAL_AXES}")

    def spec(self, *logical: Optional[str]) -> tuple:
        """The layout of a weight whose dims carry the given logical
        axes: ``rules.spec("data", "model")`` on a (D, F) projection
        FSDP-shards D and tensor-shards F; disabled rules keep every
        dim whole."""
        if not self.enabled:
            return (None,) * len(logical)
        return tuple(self._resolve(name) for name in logical)

    def batch_spec(self, batch: int, mesh) -> Optional[tuple[str, ...]]:
        """The mesh dims a leading batch dim of size ``batch`` shards
        over, or None when it cannot be sharded.  Dims are dropped from
        the right until their combined size divides ``batch``, so a
        batch of 4 on a (data=2, model=4) mesh still shards over data
        instead of failing."""
        if not self.enabled or mesh is None:
            return None
        return _divisible_axes(self, mesh, "batch", batch) or None


def _divisible_axes(rules: Rules, mesh, name: Optional[str],
                    dim: int) -> tuple[str, ...]:
    """Mesh dims for one tensor dim, dropping dims (from the right)
    that the dim's size cannot absorb evenly."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in _as_tuple(rules._resolve(name))
                 if a in shape and shape[a] > 1)
    while axes and dim % math.prod(shape[a] for a in axes):
        axes = axes[:-1]
    return axes


def _dim_axes(rules: Rules, mesh, name: Optional[str], dim: int) -> AxisName:
    axes = _divisible_axes(rules, mesh, name, dim)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def default_rules(mesh) -> Rules:
    """Canonical placements when a caller has a mesh but no Rules:
    every pod/data dim carries batch, a model dim carries features."""
    names = tuple(mesh_shape(mesh))
    data = tuple(a for a in names if a in ("pod", "data"))
    model = "model" if "model" in names else None
    return Rules(data=data, model=model, tp=model)


def batch_placement(rules: Rules, mesh, batch: int) -> tuple[str, ...]:
    """Mesh dims a batch dim of size ``batch`` shards over (dropping
    non-dividing dims, via ``Rules.batch_spec``) — shared by the kernel
    dispatcher (``kernels.ops``), the model and the tuner bridge
    (``launch.mesh.tuner_mesh_spec``) so the tuner prices exactly what
    runs."""
    return rules.batch_spec(batch, mesh) or ()


def feature_placement(rules: Rules, mesh, dim: int,
                      taken: tuple[str, ...] = ()) -> Optional[str]:
    """The tp-or-model dim, if it evenly divides ``dim`` and is not
    already in ``taken`` (the batch placement's dims)."""
    shape = mesh_shape(mesh)
    ax = rules.tp or rules.model
    if ax and ax not in taken and ax in shape \
            and shape[ax] > 1 and dim % shape[ax] == 0:
        return ax
    return None


def dispatch_mesh_spec(rules: Rules, mesh, *, kind: str, batch: int,
                       feature_dims: tuple[int, ...],
                       ici_bw: Optional[float] = None):
    """(MeshSpec, batch_axes, feature_axis) for dispatching one fused
    kernel under this mesh and regime — the one function both the
    kernel dispatcher (``kernels.ops``) and the tuner bridge
    (``launch.mesh.tuner_mesh_spec``) call.

    kind "gemm": the feature dim splits the ``h`` loop (output
    features) as a MeshSpec placement entry; ``feature_dims=(H,)``.
    kind "attention": heads fold into the chain batch, so the feature
    dim joins ``batch_axes`` and no loop is placed;
    ``feature_dims=(kv_heads, q_heads)`` — the dim must divide every
    entry, which also keeps the GQA group whole on each rank.
    ``ici_bw`` defaults to the TPU link rate, as in the JAX package.
    """
    from ..core.perf_model import V5E, MeshSpec
    if kind not in ("gemm", "attention"):
        raise ValueError(f"unknown chain kind {kind!r}")
    baxes = batch_placement(rules, mesh, batch)
    feat = (feature_placement(rules, mesh, feature_dims[0], taken=baxes)
            if feature_dims else None)
    shape = mesh_shape(mesh)
    if feat is not None and any(d % shape[feat] for d in feature_dims[1:]):
        feat = None
    ici_bw = V5E.ici_bw if ici_bw is None else ici_bw
    if kind == "attention":
        spec = MeshSpec.from_mesh(
            mesh, batch_axes=baxes + ((feat,) if feat else ()),
            ici_bw=ici_bw)
    else:
        spec = MeshSpec.from_mesh(
            mesh, placement=((("h", feat),) if feat else ()),
            batch_axes=baxes, ici_bw=ici_bw)
    return spec, baxes, feat


def ring_dispatch_spec(rules: Rules, mesh, *, batch: int, kv_len: int,
                       feature_dims: tuple[int, ...] = (),
                       ici_bw: Optional[float] = None):
    """(MeshSpec, batch_axes, reduction_axis) for the ring
    (kv-sequence-sharded) attention regime — the sibling of
    ``dispatch_mesh_spec`` that ``dist.ring_dispatch`` and
    ``launch.mesh.tuner_mesh_spec(shard_reduction=True)`` both call.
    The batch rides the rules' data dims; the tp-or-model dim splits
    the chain's ``n`` loop (the kv sequence) when it divides
    ``kv_len``, else the reduction axis is None (and the MeshSpec
    spatial-only).  ``feature_dims`` is accepted for symmetry."""
    from ..core.perf_model import V5E, MeshSpec
    shape = mesh_shape(mesh)
    baxes = batch_placement(rules, mesh, batch)
    ax = rules.tp or rules.model
    if not (ax and ax not in baxes and ax in shape
            and shape[ax] > 1 and kv_len % shape[ax] == 0):
        ax = None
    ici_bw = V5E.ici_bw if ici_bw is None else ici_bw
    spec = MeshSpec.from_mesh(
        mesh, placement=((("n", ax),) if ax else ()),
        batch_axes=baxes, ici_bw=ici_bw)
    return spec, baxes, ax


def local_shape(shape: Sequence[int], layout: Sequence[AxisName],
                mesh) -> tuple[int, ...]:
    """The per-rank shape of a tensor of global ``shape`` laid out as
    ``layout`` (one entry per dim; missing trailing entries whole)."""
    sizes = mesh_shape(mesh)
    out = []
    for i, d in enumerate(shape):
        axes = _as_tuple(layout[i]) if i < len(layout) else ()
        n = math.prod(sizes[a] for a in axes)
        if d % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axes} ({n} ranks)")
        out.append(d // n)
    return tuple(out)


def constrain(x, rules: Optional[Rules], mesh, global_shape,
              *logical: Optional[str]):
    """The counterpart of the JAX package's ``constrain``: a check that
    the local tensor ``x`` has the shape its logical layout gives the
    global ``global_shape`` on this mesh (each named dim divided by its
    dividing mesh dims, as ``_dim_axes`` resolves them); returns ``x``.

    Identity when rules are disabled or there is no mesh.  Names past
    ``x.ndim`` are ignored; unnamed trailing dims are whole.  Where the
    layout really changes, the model runs the collective itself
    (``dist.collectives``): this function moves no data."""
    if rules is None or not rules.enabled or mesh is None:
        return x
    layout = [_dim_axes(rules, mesh, name, dim)
              for dim, name in zip(global_shape, logical)]
    want = local_shape(global_shape, layout, mesh)
    if tuple(x.shape) != want:
        raise ValueError(f"local shape {tuple(x.shape)} is not {want}, the "
                         f"layout {tuple(logical)} of {tuple(global_shape)}")
    return x
