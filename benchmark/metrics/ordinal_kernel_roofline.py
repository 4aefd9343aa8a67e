"""The ordinal cutpoint kernel's share of its roofline at the window's first
sweep: the least time for that launch's inputs (``counts/ordinal_kernel``;
the proposals a lane takes are the reference's count at those inputs) over
the profiler's time of the kernel's first traced launch, which is that
sweep's. Nothing where the kernel never ran."""

from benchmark.counts.ordinal_kernel import ordinal_kernel_bound
from benchmark.trace import first_launch

KERNEL = "ordinal_cut_"  # ordinal_cut_tile_kernel, ordinal_cut_stream_kernel


def read(run):
    tr, rounds = run["trace"], run["verdict"]["rounds"]
    if tr is None or rounds is None:
        return None
    t = first_launch(tr, KERNEL)
    if not t:
        return None
    y = run["y_ref"]
    K, m = rounds[0].shape
    bound = ordinal_kernel_bound(K, y.shape[0], m, int(run["C_ref"]), (y > 0).sum(axis=0),
                                 *rounds)
    return 100.0 * bound["bound_s"] / t
