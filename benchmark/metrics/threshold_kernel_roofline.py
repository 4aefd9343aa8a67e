"""The binary cutpoint kernel's share of its roofline at the window's first
sweep: the least time for that launch's inputs (``counts/threshold_kernel``;
the proposals a lane takes are the reference's count at those inputs) over
the profiler's time of the kernel's first traced launch, which is that
sweep's."""

import numpy as np

from benchmark.counts.threshold_kernel import kernel_bound
from benchmark.trace import first_launch

KERNELS = ("ess_regs_kernel", "ess_tile_kernel", "ess_stream_kernel")


def read(run):
    tr, rounds = run["trace"], run["verdict"]["rounds"]
    if tr is None or rounds is None:
        return None
    times = [t for t in (first_launch(tr, k) for k in KERNELS) if t]
    if not times:
        return None
    y = run["y_ref"]
    K, m = rounds[0].shape
    bound = kernel_bound(K, y.shape[0], m, (y > 0).sum(axis=0), *rounds)
    return 100.0 * bound["bound_s"] / times[0]
