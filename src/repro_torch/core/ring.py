"""Ring-algorithm collective traffic formulas (docs/design.md §7).

Per-device link traffic of one collective over ``n`` participants,
expressed in terms of the *result* buffer size (matching how the HLO
parser in ``launch.hlo_analysis`` reads shapes off the optimized HLO):

    all-reduce          2 * B * (n-1) / n      (reduce-scatter + all-gather)
    all-gather          B * (n-1) / n          (B = gathered result)
    reduce-scatter      B * (n-1)              (B = the shard result)
    all-to-all          B * (n-1) / n
    collective-permute  B

Pure arithmetic with no dependencies in either direction, so both the
tuner (``core.perf_model`` — pricing collectives *before* compiling
anything) and the dry-run analyzer (``launch.hlo_analysis`` — pricing
collectives parsed *from* the compiled HLO) share one model; a mismatch
between the two would silently skew tile selection.
"""
from __future__ import annotations

RING_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")

# Per-hop launch/latency tax of a software-pipelined ring: each
# ppermute hop is a separately scheduled collective (vs one fused
# all-reduce), so the pipelined regime pays a fixed per-hop overhead on
# top of the bandwidth term.  This is what lets the serial combine win
# wire-dominated short shapes: overlap can hide bandwidth behind tile
# compute, but never the hop setup itself (docs/tuning.md).
ICI_HOP_LATENCY_S = 50e-9


def ring_traffic_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-device link traffic of one ring collective.

    result_bytes: size of the op's *result* buffer (see module doc for
    which buffer that is per kind).  n: participant count; n <= 1 means
    the collective degenerates to a local no-op.
    """
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective kind {kind!r}; "
                     f"expected one of {RING_KINDS}")


def pipelined_overlap_seconds(hop_compute_s: float, hop_wire_s: float,
                              n: int) -> float:
    """Eq (2') overlap term of the pipelined ring combine:
    ``max(hop_compute, hop_wire) * (n - 1)``.

    A balanced ring reduce-scatter over ``n`` shards runs ``n - 1``
    steady-state hops; in each, one chunk's tile compute
    (``hop_compute``) runs concurrently with one chunk's wire transfer
    (``hop_wire``), so the slot costs whichever dominates.  Properties
    the perf-model tests pin: zero at ``n <= 1`` (reduces to the serial
    pricing), monotone in hop count, and never below the per-hop wire
    lower bound ``hop_wire * (n - 1)`` — overlap hides wire behind
    compute, it does not erase it.
    """
    if n <= 1:
        return 0.0
    return max(hop_compute_s, hop_wire_s) * (n - 1)
