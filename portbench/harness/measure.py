"""The end-to-end metrics' arithmetic, from the window's step log.

A request is served a token at the host-clock return of the ``step()``
that gave it; only steps that returned inside the window count, and a
tail is the tail of every request, never a median of pieces.
"""
from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def out_tok_s(run) -> float:
    """Every token the window's steps gave, over the window's seconds."""
    return sum(s.gained for s in run.steps) / run.seconds


def itl_gaps(run) -> list:
    """Seconds between two successive window events of one request (the
    returns of two steps that each gave it tokens), and for a request
    still running at the close the open gap from its last event to the
    close."""
    gaps = []
    for s in run.served:
        times = [t for t, _ in s.events if run.t_start <= t <= run.t_end]
        gaps += list(np.diff(times))
        if times and s.outcome is None:
            gaps.append(run.t_end - times[-1])
    return gaps


def itl_p50_ms(run):
    gaps = itl_gaps(run)
    return percentile(gaps, 50) * 1e3 if gaps else None


def itl_p95_ms(run):
    gaps = itl_gaps(run)
    return percentile(gaps, 95) * 1e3 if gaps else None


def ttfts(run) -> list:
    """For every request the mix made due inside the window, submitted
    or not: seconds from its due time to the return of the step that
    gave its first token, or to the close when none came by then (a
    request that fell due while a step ran past the close was never
    submitted, and waits to the close all the same)."""
    served = {id(s.req): s for s in run.served}
    out = []
    for r in run.offered:
        due = run.t_start + r.due_s
        if not due < run.t_end:
            continue
        s = served.get(id(r))
        first = s.events[0][0] if s is not None and s.events else None
        end = first if first is not None and first <= run.t_end \
            else run.t_end
        out.append(end - due)
    return out


def ttft_p50_ms(run):
    t = ttfts(run)
    return percentile(t, 50) * 1e3 if t else None


def ttft_p95_ms(run):
    t = ttfts(run)
    return percentile(t, 95) * 1e3 if t else None


def decode_step_ms(run):
    """Mean wall of the window's steps that admitted nothing and
    decoded."""
    walls = [s.t1 - s.t0 for s in run.steps
             if not s.prefills and s.decode_keys]
    return float(np.mean(walls)) * 1e3 if walls else None


#: the end-to-end metrics by name; the open-loop cell's inter-token
#: median is ``chat_itl_p50_ms``, held to its own bound
END_TO_END = {"out_tok_s": out_tok_s, "itl_p95_ms": itl_p95_ms,
              "chat_itl_p50_ms": itl_p50_ms, "ttft_p50_ms": ttft_p50_ms}
