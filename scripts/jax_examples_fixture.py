"""Write the JAX side of chip_smoke.py's example agreement checks: the JAX
package's ``gpirt_mcmc`` calls of ``examples/senate116_walkthrough.py`` and
``examples/sdo_ordinal.py`` at their defaults, in float32 on the CPU, each
at the example's seed and at other seeds.

    JAX_PLATFORMS=cpu python3 scripts/jax_examples_fixture.py \
        [--other-seed 2119] [--sdo-runs 16] [--out tests/fixtures/examples_jax.npz]

The archive holds, for the walkthrough (senate116, 4 chains, burn 500,
2000 draws, SEED 1119): ``walk_theta_hat`` (n,), the sign-aligned
posterior means pooled over the chains as the example prints them,
``walk_chain_means`` (K, n), ``walk_senators`` (n,), the pooled and
within-chain theta ESS medians ``walk_ess_pooled`` / ``walk_ess_within``,
``walk_rhat_max``, and ``walk_r_seeds``, the Pearson r of the seed's
``theta_hat`` with the second seed's after sign alignment. For the SDO
example (1500 x 16, one chain, burn 300, 1000 draws, f* stored), run at
``--sdo-runs`` seeds (SEED 1, then the second seed and the seeds after it),
since its one chain settles in a basin that depends on the seed: by run,
``sdo_seeds`` (R,), ``sdo_theta_means`` (R, n), ``sdo_cutpoints``
(R, C - 1) of item 1, ``sdo_irf`` (R, 3), item 1's posterior-mean latent
curve at theta = -2, 0, +2, ``sdo_ll_mean`` (R,), the mean log-likelihood
of the draws, and ``sdo_r_seeds``, the signed r of SEED 1's theta means
with the second seed's. Also each call's CPU seconds (``walk_seconds``,
``sdo_seconds``, the first seed's) and the seeds.
"""

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from gpirt_tpu import gpirt_mcmc  # noqa: E402
from gpirt_tpu.utils.datasets import load_sdo, senate116_response_matrix  # noqa: E402
from gpirt_tpu.utils.diagnostics import (  # noqa: E402
    align_theta_signs,
    effective_sample_size,
    split_rhat,
)

# the examples' defaults
WALK_ITERS, WALK_BURN, WALK_CHAINS, WALK_SEED = 2000, 500, 4, 1119
SDO_ITERS, SDO_BURN, SDO_ROWS, SDO_SEED = 1000, 300, 1500, 1
IRF_ROWS = [300, 500, 700]  # theta = -2, 0, +2 on the 1001-point grid


def signed_r(a, b):
    """Pearson r of ``a`` with ``b`` after aligning ``a``'s sign to ``b``."""
    a = align_theta_signs(a[None], reference=b)[0]
    return float(np.corrcoef(a, b)[0, 1])


def walkthrough(rm, seed):
    t = time.perf_counter()
    samples = gpirt_mcmc(np.asarray(rm), sample_iterations=WALK_ITERS,
                         burn_iterations=WALK_BURN, CHAIN=WALK_CHAINS, vote_codes=None,
                         dtype="float32", SEED=seed, verbose=False)
    seconds = time.perf_counter() - t
    theta = np.stack([c["theta"][:, :, 0] for c in samples])  # (K, S, n)
    aligned = np.stack([align_theta_signs(c, reference=theta[0, 0]) for c in theta])
    per_chain = np.stack([effective_sample_size(c[None]) for c in aligned])
    return {
        "theta_hat": aligned.mean(axis=(0, 1)),
        "chain_means": aligned.mean(axis=1),
        "ess_pooled": float(np.median(effective_sample_size(aligned))),
        "ess_within": float(np.median(per_chain)),
        "rhat_max": float(np.nanmax(split_rhat(aligned))),
        "seconds": seconds,
    }


def sdo(data, seed):
    t = time.perf_counter()
    d = gpirt_mcmc(data, sample_iterations=SDO_ITERS, burn_iterations=SDO_BURN,
                   vote_codes=None, store_fstar=True, SEED=seed, verbose=False)[0]
    seconds = time.perf_counter() - t
    thr = d["threshold"][..., 0]  # (S, m, C+1)
    irf = d["fstar"][..., 0].mean(axis=0)  # (N, m)
    return {
        "theta_mean": d["theta"][:, :, 0].mean(axis=0),
        "cutpoints": thr.mean(axis=0)[0][1:-1],
        "irf": irf[IRF_ROWS, 0],
        "ll_mean": float(d["ll"].mean()),
        "seconds": seconds,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-seed", type=int, default=2119)
    ap.add_argument("--sdo-runs", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures",
                                                  "examples_jax.npz"))
    args = ap.parse_args()

    rm, senators, _ = senate116_response_matrix()
    walk = walkthrough(rm, WALK_SEED)
    print(f"walkthrough SEED {WALK_SEED}: {walk['seconds']:.1f} s, ESS pooled "
          f"{walk['ess_pooled']:.1f} within {walk['ess_within']:.1f}, R-hat max "
          f"{walk['rhat_max']:.3f}", flush=True)
    walk2 = walkthrough(rm, args.other_seed)
    walk_r = signed_r(walk2["theta_hat"], walk["theta_hat"])
    print(f"walkthrough SEED {args.other_seed}: {walk2['seconds']:.1f} s, R-hat max "
          f"{walk2['rhat_max']:.3f}; r between the seeds {walk_r:.5f}", flush=True)

    data = load_sdo()[:SDO_ROWS]
    seeds = [SDO_SEED] + [args.other_seed + i for i in range(args.sdo_runs - 1)]
    runs = []
    for seed in seeds:
        runs.append(sdo(data, seed))
        print(f"SDO SEED {seed}: {runs[-1]['seconds']:.1f} s, mean ll "
              f"{runs[-1]['ll_mean']:.1f}, cutpoints item 1 "
              f"{np.round(runs[-1]['cutpoints'], 3)}, IRF {np.round(runs[-1]['irf'], 3)}, "
              f"r with SEED {SDO_SEED} "
              f"{signed_r(runs[-1]['theta_mean'], runs[0]['theta_mean']):.5f}", flush=True)
    sdo_r = signed_r(runs[1]["theta_mean"], runs[0]["theta_mean"])

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out,
             walk_theta_hat=walk["theta_hat"], walk_chain_means=walk["chain_means"],
             walk_senators=senators, walk_ess_pooled=walk["ess_pooled"],
             walk_ess_within=walk["ess_within"], walk_rhat_max=walk["rhat_max"],
             walk_r_seeds=walk_r, walk_seconds=walk["seconds"], walk_seed=WALK_SEED,
             sdo_seeds=np.asarray(seeds),
             sdo_theta_means=np.stack([r["theta_mean"] for r in runs]),
             sdo_cutpoints=np.stack([r["cutpoints"] for r in runs]),
             sdo_irf=np.stack([r["irf"] for r in runs]),
             sdo_ll_mean=np.asarray([r["ll_mean"] for r in runs]),
             sdo_r_seeds=sdo_r, sdo_seconds=runs[0]["seconds"], sdo_seed=SDO_SEED,
             other_seed=args.other_seed)
    print(f"wrote {args.out} ({jax.devices()[0].platform}, {os.cpu_count()} cores)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
