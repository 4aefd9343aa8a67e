"""Convergence diagnostics: theta sign alignment and effective sample size.

Counterpart of ``gpirt_tpu/utils/diagnostics.py`` for the main path's
scoring: the numpy estimator and its on-device twin, which keeps the draw
arrays on the card and returns only the (P,) ESS vector. ESS follows BDA3
sec. 11.4-11.5 with Geyer's initial monotone sequence.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "align_theta_signs",
    "effective_sample_size",
    "effective_sample_size_device",
]


def align_theta_signs(theta_draws: np.ndarray, reference: np.ndarray = None) -> np.ndarray:
    """Resolve the theta -> -theta reflection of the posterior: multiply
    each draw s by sign(<draw_s, reference>) (reference: the first draw).

    theta_draws: (S, n) or (S, n, H).
    """
    t = np.asarray(theta_draws, np.float64)
    flat = t.reshape(t.shape[0], -1)
    if reference is None:
        reference = flat[0]
    ref = np.asarray(reference, np.float64).reshape(-1)
    ref = ref - ref.mean()
    proj = (flat - flat.mean(axis=1, keepdims=True)) @ ref
    sign = np.where(proj < 0, -1.0, 1.0)
    return t * sign.reshape((-1,) + (1,) * (t.ndim - 1))


def _to_chain_array(draws: np.ndarray) -> np.ndarray:
    """(S,) or (S, P) single chain, or (K, S, ...) multi-chain -> (K, S, P)."""
    a = np.asarray(draws, np.float64)
    if a.ndim == 1:
        a = a[None, :, None]
    elif a.ndim == 2:
        a = a[None]
    else:
        a = a.reshape(a.shape[0], a.shape[1], -1)
    return a


def _autocov(x: np.ndarray) -> np.ndarray:
    """Autocovariance via FFT for each column of (S, P)."""
    S, _ = x.shape
    xc = x - x.mean(axis=0)
    n_fft = 1 << int(np.ceil(np.log2(2 * S)))
    f = np.fft.rfft(xc, n=n_fft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=0)[:S].real
    return acov / S


def effective_sample_size(draws: np.ndarray) -> np.ndarray:
    """ESS per parameter; draws (K, S, ...) or (S, ...). Chains are pooled
    with the cross-chain variance folded in (R-hat-style var_plus)."""
    a = _to_chain_array(draws)
    K, S, P = a.shape
    if S < 4:
        return np.full(P, float(K * S))
    chain_acov = np.stack([_autocov(a[k]) for k in range(K)])  # (K, S, P)
    chain_var = chain_acov[:, 0] * S / (S - 1.0)
    W = chain_var.mean(axis=0)
    mean_acov = chain_acov.mean(axis=0)
    if K > 1:
        var_plus = W * (S - 1.0) / S + a.mean(axis=1).var(axis=0, ddof=1)
    else:
        var_plus = W * (S - 1.0) / S + 1e-300
    rho = 1.0 - (W - mean_acov) / var_plus
    rho[0] = 1.0
    # Geyer: sum pairs rho[2t] + rho[2t+1] while positive, made monotone
    T = (S - 1) // 2
    pair = rho[1: 2 * T + 1].reshape(T, 2, P).sum(axis=1)  # (T, P)
    pair_min = np.minimum.accumulate(pair, axis=0)
    positive = pair_min > 0
    cutoff = np.where((~positive).any(axis=0), np.argmax(~positive, axis=0), T)
    contrib = np.where(positive & (np.arange(T)[:, None] < cutoff[None, :]),
                       pair_min, 0.0)
    tau = np.maximum(-1.0 + 2.0 * contrib.sum(axis=0),
                     1.0 / np.log10(max(S, 10)))
    return np.minimum(K * S / tau, K * S * np.log10(max(S, 10)))


def effective_sample_size_device(draws: torch.Tensor, align_signs: bool = True):
    """Pooled ESS per parameter on the draws' device, in float32.

    Args:
      draws: (K, S, P) tensor, chains first.
      align_signs: resolve the theta reflection per draw against chain 0's
        first draw before pooling.
    """
    x = draws.to(torch.float32)
    K, S, P = x.shape
    if S < 4:
        return torch.full((P,), float(K * S), dtype=torch.float32, device=x.device)
    if align_signs:
        ref = x[0, 0] - x[0, 0].mean()
        cent = x - x.mean(dim=2, keepdim=True)
        proj = cent @ ref  # (K, S)
        x = x * torch.where(proj < 0, -1.0, 1.0).unsqueeze(-1)

    nfft = 1 << int(np.ceil(np.log2(2 * S)))
    xc = x - x.mean(dim=1, keepdim=True)
    f = torch.fft.rfft(xc, n=nfft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=1)[:, :S] / S  # (K, S, P)
    chain_var = acov[:, 0] * S / (S - 1.0)
    W = chain_var.mean(dim=0)
    mean_acov = acov.mean(dim=0)
    if K > 1:
        var_plus = W * (S - 1.0) / S + x.mean(dim=1).var(dim=0, correction=1)
    else:
        var_plus = W * (S - 1.0) / S + 1e-30
    rho = 1.0 - (W - mean_acov) / var_plus
    rho[0] = 1.0
    T = (S - 1) // 2
    pair = rho[1: 2 * T + 1].reshape(T, 2, P).sum(dim=1)  # (T, P)
    pair_min = torch.cummin(pair, dim=0).values
    positive = pair_min > 0
    bad = ~positive
    first_bad = torch.argmax(bad.to(torch.int8), dim=0)  # first index on ties
    cutoff = torch.where(bad.any(dim=0), first_bad, torch.full_like(first_bad, T))
    idx = torch.arange(T, device=x.device)[:, None]
    contrib = torch.where(positive & (idx < cutoff[None, :]), pair_min, 0.0)
    tau = torch.clamp(-1.0 + 2.0 * contrib.sum(dim=0),
                      min=1.0 / np.log10(max(S, 10)))
    return torch.clamp(K * S / tau, max=K * S * np.log10(max(S, 10)))
