"""Reduction of the traced stretch's ``torch.profiler`` events.

Device operations are the profiler's device events (kernels, copies,
sets) other than the device-side images of the harness's own
``record_function`` spans.  ``busy_s`` is the length of the union of
their intervals inside the stretch; an idle gap is a stretch of that
window with none running, named after what the host was doing at its
middle: the harness span (``harness.step``, ``harness.wait``,
``harness.book``) and the innermost host operation covering it.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict              # device seconds by operation name
    idle: dict                  # idle seconds by host activity

    def seconds(self, kernels) -> float:
        """Device seconds of the operations named after any of
        ``kernels`` (a kernel's name as the profiler gives it carries its
        namespace, template arguments and signature)."""
        return sum(s for n, s in self.kernel_s.items() if _named(n, kernels))

    def breakdown(self) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def _named(name: str, kernels) -> bool:
    return any(re.search(rf"(^|[\s:]){k}($|[<(\s])", name) for k in kernels)


def _is_device(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type != DeviceType.CPU


def reduce(events, window_s: float, spans=()) -> Trace:
    """events: the profiler's ``FunctionEvent`` list, times in
    microseconds from the trace's start; window_s: the stretch's length
    on the host clock."""
    end = window_s * 1e6
    dev, host, outer = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _is_device(e):
            if e.name in spans or b <= a:
                continue
            dev.append((max(a, 0.0), min(b, end), e.name))
        elif e.name in spans:
            outer.append((a, b, e.name))
        else:
            host.append((a, b, e.name))
    kernel_s = defaultdict(float)
    for a, b, n in dev:
        if b > a:
            kernel_s[n] += (b - a) * 1e-6
    merged = []
    for a, b, _ in sorted(d for d in dev if d[1] > d[0]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    edges = [0.0] + [x for ab in merged for x in ab] + [end]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        mid = (a + b) / 2
        what = next((n for s, t, n in outer if s <= mid <= t), "harness")
        j = bisect.bisect_right(starts, mid) - 1
        inner = None
        for k in range(j, max(j - 4000, -1), -1):
            if host[k][1] >= mid:
                inner = host[k][2]
                break
        idle[f"{what}:{inner}" if inner else what] += (b - a) * 1e-6
    return Trace(window_s, busy, dict(kernel_s), dict(idle))
