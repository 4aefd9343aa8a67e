"""Convergence diagnostics: theta sign alignment, split R-hat, effective
sample size and basin structure.

Counterpart of ``gpirt_tpu/utils/diagnostics.py``: numpy estimators (split
and rank-normalized R-hat, bulk and tail ESS, basin clusters and their
summary) and the on-device twin of the ESS, which keeps the draw arrays on
the card and returns only the ESS vector, one a campaign when given a
campaign axis. ESS follows BDA3 sec. 11.4-11.5 with Geyer's initial
monotone sequence; the rank-normalized statistics follow Vehtari et al.
(2021).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "align_theta_signs",
    "split_rhat",
    "rank_normalized_rhat",
    "effective_sample_size",
    "effective_sample_size_device",
    "tail_ess",
    "basin_clusters",
    "summarize",
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


def split_rhat(draws: np.ndarray) -> np.ndarray:
    """Split R-hat per parameter; draws (K, S, ...) chains first."""
    a = _to_chain_array(draws)
    K, S, P = a.shape
    half = S // 2
    a = a[:, : 2 * half].reshape(K * 2, half, P)
    chain_means = a.mean(axis=1)  # (2K, P)
    chain_vars = a.var(axis=1, ddof=1)  # (2K, P)
    W = chain_vars.mean(axis=0)
    B = half * chain_means.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * W + B / half
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / W)


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
      draws: (K, S, P) tensor, chains first, or (R, K, S, P) with a leading
        campaign axis, each campaign its own pooled estimate (as
        ``jax.vmap(effective_sample_size_device)``).
      align_signs: resolve the theta reflection per draw against chain 0's
        first draw (of the draw's own campaign) before pooling.
    Returns (P,), or (R, P) with a campaign axis.
    """
    x = draws.to(torch.float32)
    if x.ndim not in (3, 4):
        raise ValueError(f"draws must be (K, S, P) or (R, K, S, P), got {tuple(x.shape)}")
    lead, (K, S, P) = tuple(x.shape[:-3]), x.shape[-3:]
    if S < 4:
        return torch.full(lead + (P,), float(K * S), dtype=torch.float32, device=x.device)
    if align_signs:
        ref = x[..., 0, 0, :]
        ref = ref - ref.mean(dim=-1, keepdim=True)  # (*R, P)
        cent = x - x.mean(dim=-1, keepdim=True)
        proj = cent @ ref.unsqueeze(-2).unsqueeze(-1)  # (*R, K, S, 1)
        x = x * torch.where(proj < 0, -1.0, 1.0)

    nfft = 1 << int(np.ceil(np.log2(2 * S)))
    xc = x - x.mean(dim=-2, keepdim=True)
    f = torch.fft.rfft(xc, n=nfft, dim=-2)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-2)[..., :S, :] / S  # (*R, K, S, P)
    chain_var = acov[..., 0, :] * S / (S - 1.0)  # (*R, K, P)
    W = chain_var.mean(dim=-2)
    mean_acov = acov.mean(dim=-3)  # (*R, S, P)
    if K > 1:
        var_plus = W * (S - 1.0) / S + x.mean(dim=-2).var(dim=-2, correction=1)
    else:
        var_plus = W * (S - 1.0) / S + 1e-30
    rho = 1.0 - (W.unsqueeze(-2) - mean_acov) / var_plus.unsqueeze(-2)
    rho[..., 0, :] = 1.0
    T = (S - 1) // 2
    pair = rho[..., 1: 2 * T + 1, :].reshape(lead + (T, 2, P)).sum(dim=-2)  # (*R, T, P)
    pair_min = torch.cummin(pair, dim=-2).values
    positive = pair_min > 0
    bad = ~positive
    first_bad = torch.argmax(bad.to(torch.int8), dim=-2)  # first index on ties
    cutoff = torch.where(bad.any(dim=-2), first_bad, torch.full_like(first_bad, T))
    idx = torch.arange(T, device=x.device)[:, None]
    contrib = torch.where(positive & (idx < cutoff.unsqueeze(-2)), pair_min, 0.0)
    tau = torch.clamp(-1.0 + 2.0 * contrib.sum(dim=-2),
                      min=1.0 / np.log10(max(S, 10)))
    return torch.clamp(K * S / tau, max=K * S * np.log10(max(S, 10)))


def _rank_normalize(a: np.ndarray) -> np.ndarray:
    """Pooled-rank normal scores per parameter: (K, S, P) -> (K, S, P),
    z = Phi^-1((r - 3/8) / (K S + 1/4)) of the fractional ranks."""
    K, S, P = a.shape
    flat = a.reshape(K * S, P)
    order = np.argsort(flat, axis=0, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(K * S)[:, None], axis=0)
    p = torch.as_tensor((ranks + 1 - 0.375) / (K * S + 0.25), dtype=torch.float64)
    return torch.special.ndtri(p).numpy().reshape(K, S, P)


def rank_normalized_rhat(draws: np.ndarray) -> np.ndarray:
    """Rank-normalized split R-hat: the larger of the bulk statistic (rank
    normal scores) and the folded one (|x - median|, tail-sensitive)."""
    a = _to_chain_array(draws)
    bulk = split_rhat(_rank_normalize(a))
    folded = np.abs(a - np.median(a.reshape(-1, a.shape[-1]), axis=0))
    tail = split_rhat(_rank_normalize(folded))
    return np.maximum(bulk, tail)


def tail_ess(draws: np.ndarray, prob: float = 0.05) -> np.ndarray:
    """Tail ESS: the smaller ESS of the lower and upper ``prob``-quantile
    exceedance indicators."""
    a = _to_chain_array(draws)
    flat = a.reshape(-1, a.shape[-1])
    q_lo = np.quantile(flat, prob, axis=0)
    q_hi = np.quantile(flat, 1.0 - prob, axis=0)
    lo = effective_sample_size((a <= q_lo).astype(np.float64))
    hi = effective_sample_size((a >= q_hi).astype(np.float64))
    return np.minimum(lo, hi)


def basin_clusters(theta_draws: np.ndarray, corr_threshold: float = 0.9) -> dict:
    """Group chains into posterior basins by their sign-aligned theta means:
    a greedy leader pass over |correlation| at ``corr_threshold``.

    Args:
      theta_draws: (K, S, n) per-chain draws, or (K, n) chain means.
    Returns:
      dict with "labels" (K,), "n_clusters", "sizes", "within_corr_min"
      (worst member-to-leader correlation) and "between_corr_max" (highest
      leader-to-leader correlation).
    """
    t = np.asarray(theta_draws, np.float64)
    if t.ndim == 3:
        t = align_theta_signs(t.reshape(-1, t.shape[-1])).reshape(t.shape)
        means = t.mean(axis=1)  # (K, n)
    else:
        means = t
    ref = means[0] - means[0].mean()
    cent = means - means.mean(axis=1, keepdims=True)
    sign = np.where(cent @ ref < 0, -1.0, 1.0)
    cent = cent * sign[:, None]
    norms = np.linalg.norm(cent, axis=1) + 1e-300
    unit = cent / norms[:, None]

    K = unit.shape[0]
    labels = np.full(K, -1, int)
    leaders, within = [], []
    for k in range(K):
        best, best_c = -1, -np.inf
        for ci, lead in enumerate(leaders):
            c = abs(float(unit[k] @ unit[lead]))
            if c > best_c:
                best, best_c = ci, c
        if best >= 0 and best_c >= corr_threshold:
            labels[k] = best
            within.append(best_c)
        else:
            labels[k] = len(leaders)
            leaders.append(k)
    between = [abs(float(unit[a] @ unit[b]))
               for i, a in enumerate(leaders) for b in leaders[i + 1:]]
    sizes = np.bincount(labels, minlength=len(leaders))
    return {
        "labels": labels,
        "n_clusters": int(len(leaders)),
        "sizes": sizes.tolist(),
        "within_corr_min": float(min(within)) if within else 1.0,
        "between_corr_max": float(max(between)) if between else 0.0,
    }


def summarize(draws: np.ndarray) -> dict:
    """Min / median ESS, min tail ESS, and max plain and rank-normalized
    R-hat."""
    ess = effective_sample_size(draws)
    te = tail_ess(draws)
    return {
        "ess_min": float(np.nanmin(ess)),
        "ess_median": float(np.nanmedian(ess)),
        "ess_tail_min": float(np.nanmin(te)),
        "rhat_max": float(np.nanmax(split_rhat(draws))),
        "rhat_rank_max": float(np.nanmax(rank_normalized_rhat(draws))),
    }
