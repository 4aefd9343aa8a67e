"""Reading a ``torch.profiler`` trace of part of the window: the device's busy
time, the operations that took most of it, the idle gaps by what the host
was doing, and each launch of a named kernel."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

WINDOW_MARK = "benchmark.traced_window"
NAME_CHARS = 160  # a device operation's name as reported: kernel names run to thousands


class Trace(NamedTuple):
    window_s: float  # the traced window's length
    busy_s: float  # seconds in which an operation ran on the device
    sweeps: int  # sweeps in the traced window
    device_ops: List[list]  # [name, seconds] by total time, the top 10
    idle_gaps: List[list]  # [host activity, seconds] by idle time, the top 10
    launches: Dict[str, List[float]]  # device op name -> each launch's seconds, in order


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    return fn() if fn is not None else 1000 * getattr(ev, f"{what}_us")()


def _events(prof):
    """Raw events (name, device?, start ns, duration ns) of a stopped profiler."""
    results = getattr(prof, "profiler", prof).kineto_results
    out = []
    for ev in results.events():
        on_device = ev.device_type() != torch.autograd.DeviceType.CPU
        out.append((ev.name(), on_device, _ns(ev, "start"), _ns(ev, "duration")))
    return out


def read_trace(prof, sweeps: int) -> Optional[Trace]:
    """The trace of a stopped profiler inside its :data:`WINDOW_MARK`
    range; None when no operation ran on the device (a CPU run)."""
    return summarize(_events(prof), sweeps)


def summarize(events, sweeps: int) -> Optional[Trace]:
    """:class:`Trace` of raw events (name, on the device?, start ns,
    duration ns)."""
    marks = [(s, s + d) for name, dev, s, d in events if not dev and name == WINDOW_MARK]
    # the mark shows on the device's timeline too, as an annotation: not an operation
    dev_ev = [(s, s + d, name[:NAME_CHARS]) for name, dev, s, d in events
              if dev and d > 0 and name != WINDOW_MARK]
    if not marks or not dev_ev:
        return None
    w0, w1 = marks[0]
    dev_ev = sorted((max(s, w0), min(e, w1), name) for s, e, name in dev_ev if e > w0 and s < w1)
    # the union of the device intervals, and the gaps between them
    busy, gaps, cur_s, cur_e = 0, [], w0, w0
    for s, e, _ in dev_ev:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if w1 > cur_e:
        gaps.append((cur_e, w1))
    by_op, launches = defaultdict(int), defaultdict(list)
    for s, e, name in dev_ev:
        by_op[name] += e - s
        launches[name].append((e - s) / 1e9)
    host = sorted((s, s + d, name[:NAME_CHARS]) for name, dev, s, d in events
                  if not dev and name != WINDOW_MARK and d > 0)
    starts = [h[0] for h in host]
    by_host = defaultdict(int)
    for g0, g1 in gaps:
        by_host[_host_activity(host, starts, (g0 + g1) // 2)] += g1 - g0
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Trace((w1 - w0) / 1e9, busy / 1e9, sweeps, top(by_op), top(by_host), dict(launches))


def _host_activity(host, starts, t: int, depth: int = 256) -> str:
    """The innermost host operation in flight at ``t``: of the operations
    that cover it, the one that started last; "python" where none does (the
    host between operations)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - depth), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "python"


def first_launch(trace: Trace, fragment: str) -> Optional[float]:
    """Seconds of the first traced launch of the device operation whose name
    holds ``fragment`` (one kernel of that name runs in a cell)."""
    for name, times in trace.launches.items():
        if fragment in name and times:
            return times[0]
    return None
