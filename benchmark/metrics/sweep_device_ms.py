"""Milliseconds the device was busy a sweep in the traced part of the window
(the profiler's union of device operations over the traced sweeps)."""


def read(run):
    tr = run["trace"]
    return None if tr is None or tr.sweeps == 0 else 1e3 * tr.busy_s / tr.sweeps
