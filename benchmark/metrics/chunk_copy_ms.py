"""Milliseconds a chunk's stored draws take to reach host numpy, timed after
a synchronize so that it holds the copy and not the chunk's sweeps; the
mean over the window's chunks."""


def read(run):
    copies = run["copy_s"]
    return 1e3 * sum(copies) / len(copies) if copies else None
