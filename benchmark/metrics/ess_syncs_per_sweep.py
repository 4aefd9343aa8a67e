"""Device-to-host syncs of ``ops/ess.ess_update`` (its ``syncs`` counter) a
sweep over the window: one for each round of a host-looped slice update."""


def read(run):
    return run["ess_syncs"] / run["sweeps"] if run["sweeps"] else None
