"""The sweep's share of the card's float32 peak: the operations of one sweep
counted from the cell's shapes by the count of the cell's sampler
(``counts/<reference>.py``, named as the configuration's reference) times
the sweeps of the window's untraced part over its seconds, against 67
TFLOP/s."""

from benchmark.cells import load_module
from benchmark.counts.peaks import FP32_FLOP_PER_S


def read(run):
    cfg = run["config"]
    count = load_module("counts", run["cell"].config["reference"]).sweep_flops
    flops = count(run["cell"].traffic["chains"], cfg.n, cfg.m, cfg.C, cfg.grid_size)
    sweeps, seconds = run["sweeps"], run["window_s"]
    if run["traced"] is not None:
        sweeps, seconds = sweeps - run["traced"][0], seconds - run["traced"][1]
    if sweeps <= 0 or seconds <= 0:
        return None
    return 100.0 * flops * sweeps / seconds / FP32_FLOP_PER_S
