"""Effective theta samples a second: the median over respondents of the
within-chain ESS of the window's theta draws, summed over the chains
(``diagnostics.py``, bench.py's basis), over the window's seconds."""

import torch

from benchmark.diagnostics import within_chain_ess_median


def read(run):
    theta = run["host"]["theta"]  # (K, S, 1, n)
    if theta.shape[1] < 4:
        return None
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return within_chain_ess_median(torch.as_tensor(theta[:, :, 0], device=dev)) / run["window_s"]
