"""bench.py's spread theta inits: for each chain one permutation of an even
spread over [-2, 2], drawn from the run's seed."""

import numpy as np


def inits(seed: int, K: int, n: int) -> np.ndarray:
    """(K, 1, n) initial theta."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(np.linspace(-2.0, 2.0, n))[None] for _ in range(K)])
