"""Floating-point operations of one conjugate Gibbs sweep of K chains, one
session, counted from the cell's shapes: the same count whatever
implements the sweep. A transcendental (erf, erfinv, exp, log) counts as one
operation, like an add or a multiply. Work that depends on the data (the
cutpoint slice sampler's rounds past its first proposal) is not counted,
so the count is a floor of the work and a share of the peak from it never
overstates.

Per chain, with N grid points, n respondents, m items, C categories and a
grid basis of b = q + 3 columns:

  theta table    2 N (m C) n      log-probabilities (N m C) contracted
                                  with the one-hot of y
                 N m (4 (C - 1) + 3 C)   the log-probabilities: per interior
                                  cutpoint a subtract, scale, erf and
                                  affine; per category a subtract, add, log
                 2 N 3 m          the parametric mean on the grid
                 5 n N            log prior, Gumbel noise (two logs), add, argmax
  z              n m 14           the mean, two normal CDFs, the interval,
                                  erfinv, clamps
  f*             2 n b m + 2 n b m + 2 n b^2 + b^3 / 3 + 2 b^2 m
                                  the prior at the sites, U^T r, U^T U, its
                                  factor and solve
                 2 N b m + 2 N m  the push-through onto the grid
  beta           2 n 9 + 2 n 3 m + m (3^3 / 3 + 4 3^2)   moments, X^T X,
                                  X^T z, each item's 3 x 3 draw
  cutpoints      2 n m (C + 3 (C - 1))   the slice level and a first
                                  proposal: both likelihoods over the sites
  ll             n m (3 C + 2)    the trace
"""

EIGEN_BASIS = 35  # q + 3: the 32-column squared-exponential basis and the mean's 3


def sweep_flops(K: int, n: int, m: int, C: int, N: int, b: int = EIGEN_BASIS) -> float:
    table = 2 * N * (m * C) * n + N * m * (4 * (C - 1) + 3 * C) + 2 * N * 3 * m + 5 * n * N
    z = 14 * n * m
    fstar = (4 * n * b * m + 2 * n * b * b + b ** 3 / 3 + 2 * b * b * m
             + 2 * N * b * m + 2 * N * m)
    beta = 2 * n * 9 + 2 * n * 3 * m + m * (9 + 36)
    cut = 2 * n * m * (C + 3 * (C - 1))
    ll = n * m * (3 * C + 2)
    return float(K * (table + z + fstar + beta + cut + ll))
