"""Lockstep sweeps of all the chains completed in the window, over all of
its time on the host clock, the chunks' copies to the host included."""


def read(run):
    return run["sweeps"] / run["window_s"]
