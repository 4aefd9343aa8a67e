"""Launches of the ordinal cutpoint kernel in the profiler's trace over the
traced window's sweeps: 1 where each sweep's cutpoint update is one launch,
nothing where the kernel never ran."""

from benchmark.metrics.ordinal_kernel_roofline import KERNEL


def read(run):
    tr = run["trace"]
    if tr is None or not run["traced"] or not run["traced"][0]:
        return None
    launches = sum(len(t) for name, t in tr.launches.items() if KERNEL in name)
    return launches / run["traced"][0] if launches else None
