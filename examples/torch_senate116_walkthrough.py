"""End-to-end senate116 walkthrough on the PyTorch port (the reference
vignette workflow, vignettes/gpirt-vignette.Rmd:115-161, on a CUDA card).

The counterpart of ``examples/senate116_walkthrough.py``: the same
arguments, defaults and printout, on ``gpirt_tpu_torch``. Reshapes the tidy
Voteview roll-call frame into a response matrix, runs the GP-IRT sampler,
and reports ideology estimates with convergence diagnostics.

Run:  python examples/torch_senate116_walkthrough.py [--iters 2000] [--chains 4]
          [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from gpirt_tpu_torch import gpirt_mcmc  # noqa: E402
from gpirt_tpu_torch.utils.datasets import senate116_response_matrix  # noqa: E402
from gpirt_tpu_torch.utils.diagnostics import (  # noqa: E402
    align_theta_signs,
    effective_sample_size,
    split_rhat,
)

SEED = 1119  # the vignette's seed


def main(argv=None):
    """Runs the walkthrough; returns what it printed: ``theta_hat`` (n,),
    the sign-aligned posterior means pooled over the chains, ``senators``
    (n,) icpsr ids, ``chain_means`` (K, n), the pooled and within-chain
    theta ESS medians ``ess_pooled`` / ``ess_within``, ``rhat_max`` and
    ``seconds``, the wall of the gpirt_mcmc call."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--burn", type=int, default=500)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. data: spread the tidy frame, recode to {-1, 1, NaN}, drop unanimous
    rm, senators, rollcalls = senate116_response_matrix(verbose=True)
    print(f"response matrix: {rm.shape[0]} senators x {rm.shape[1]} roll calls")

    # 2. sample (vote_codes=None because rm is already response-coded)
    t = time.perf_counter()
    samples = gpirt_mcmc(
        np.asarray(rm),
        sample_iterations=args.iters,
        burn_iterations=args.burn,
        CHAIN=args.chains,
        vote_codes=None,
        dtype=args.dtype,
        SEED=SEED,
        device=args.device,
    )
    seconds = time.perf_counter() - t

    # 3. ideology estimates: sign-align draws (theta reflection), pool chains
    theta = np.stack([c["theta"][:, :, 0] for c in samples])  # (K, S, n)
    ref = theta[0, 0]
    aligned = np.stack([align_theta_signs(c, reference=ref) for c in theta])
    theta_hat = aligned.mean(axis=(0, 1))

    ess = effective_sample_size(aligned)
    rhat = split_rhat(aligned)
    per_chain = np.stack([effective_sample_size(c[None]) for c in aligned])
    rhat_max = float(np.nanmax(rhat))
    print(f"theta ESS (pooled, cross-chain variance folded in): "
          f"median {np.median(ess):.0f}")
    print(f"theta ESS (within-chain): median {np.median(per_chain):.0f}")
    print(f"split R-hat: max {rhat_max:.3f}"
          + ("  <- chains in distinct posterior modes (the GP-IRT posterior"
             " is multi-modal under the default wide IRF priors; rankings"
             " below are stable across chains)"
             if rhat_max > 1.1 else ""))

    order = np.argsort(theta_hat)
    print("\nmost conservative (highest theta):")
    for i in order[-5:][::-1]:
        print(f"  icpsr {senators[i]}: {theta_hat[i]:+.2f}")
    print("most liberal (lowest theta):")
    for i in order[:5]:
        print(f"  icpsr {senators[i]}: {theta_hat[i]:+.2f}")
    return {
        "theta_hat": theta_hat,
        "senators": senators,
        "chain_means": aligned.mean(axis=1),
        "ess_pooled": float(np.median(ess)),
        "ess_within": float(np.median(per_chain)),
        "rhat_max": rhat_max,
        "seconds": seconds,
    }


if __name__ == "__main__":
    main()
