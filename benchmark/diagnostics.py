"""Effective sample size of the window's theta draws: a copy of
``gpirt_tpu_torch.utils.diagnostics.effective_sample_size_device`` (the
arithmetic of the repository's headline benchmark, Geyer's initial
monotone sequence over an FFT autocovariance), kept here so that the
benchmark's yardstick does not move with the program."""

from __future__ import annotations

import numpy as np
import torch


def pooled_ess(draws: torch.Tensor, align_signs: bool = True) -> torch.Tensor:
    """Pooled ESS per parameter of (K, S, P) draws, chains first, in
    float32; with ``align_signs`` each draw's theta reflection is resolved
    against chain 0's first draw before pooling. Returns (P,)."""
    x = draws.to(torch.float32)
    K, S, P = x.shape
    if S < 4:
        return torch.full((P,), float(K * S), dtype=torch.float32, device=x.device)
    if align_signs:
        ref = x[0, 0, :]
        ref = ref - ref.mean()
        cent = x - x.mean(dim=-1, keepdim=True)
        proj = cent @ ref.unsqueeze(-1)  # (K, S, 1)
        x = x * torch.where(proj < 0, -1.0, 1.0)
    nfft = 1 << int(np.ceil(np.log2(2 * S)))
    xc = x - x.mean(dim=-2, keepdim=True)
    f = torch.fft.rfft(xc, n=nfft, dim=-2)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-2)[:, :S, :] / S  # (K, S, P)
    W = (acov[:, 0, :] * S / (S - 1.0)).mean(dim=0)
    mean_acov = acov.mean(dim=0)  # (S, P)
    if K > 1:
        var_plus = W * (S - 1.0) / S + x.mean(dim=-2).var(dim=0, correction=1)
    else:
        var_plus = W * (S - 1.0) / S + 1e-30
    rho = 1.0 - (W.unsqueeze(0) - mean_acov) / var_plus.unsqueeze(0)
    rho[0, :] = 1.0
    T = (S - 1) // 2
    pair = rho[1: 2 * T + 1, :].reshape(T, 2, P).sum(dim=1)  # (T, P)
    pair_min = torch.cummin(pair, dim=0).values
    positive = pair_min > 0
    bad = ~positive
    first_bad = torch.argmax(bad.to(torch.int8), dim=0)  # first index on ties
    cutoff = torch.where(bad.any(dim=0), first_bad, torch.full_like(first_bad, T))
    idx = torch.arange(T, device=x.device)[:, None]
    contrib = torch.where(positive & (idx < cutoff.unsqueeze(0)), pair_min, 0.0)
    tau = torch.clamp(-1.0 + 2.0 * contrib.sum(dim=0), min=1.0 / np.log10(max(S, 10)))
    return torch.clamp(K * S / tau, max=K * S * np.log10(max(S, 10)))


def within_chain_ess_median(theta: torch.Tensor) -> float:
    """The median over the parameters of the within-chain ESS summed over
    the chains (bench.py's basis): theta (K, S, P)."""
    per_chain = torch.stack([pooled_ess(theta[k:k + 1]) for k in range(theta.shape[0])])
    return float(per_chain.sum(dim=0).median())
