"""Percent of the traced window in which no operation ran on the device."""


def read(run):
    tr = run["trace"]
    return None if tr is None or tr.window_s <= 0 else 100.0 * (1.0 - tr.busy_s / tr.window_s)
