"""Write the JAX side of chip_smoke.py's campaign agreement check: the JAX
package's ``gpirt_campaigns`` on senate116 in float32 on the CPU, at
campaigns8's schedule (``campaign_schedule(2)``: 64 chains a campaign, SMC
160 steps from T = 64, burn 25, 100 draws, Newton cutpoints) unless
``--chains`` says fewer.

    JAX_PLATFORMS=cpu python3 scripts/jax_campaign_fixture.py \
        [--campaigns 8] [--chains 64] [--seed 100000] \
        [--out tests/fixtures/campaigns8_senate116_jax.npz]

The archive holds ``campaign_means`` (R, n), ``theta_se`` (n,),
``theta_mean`` (n,), the resolved schedule (``n_campaigns``, ``n_chains``,
``sample_iterations``, ``burn_iterations``, ``smc_steps``,
``smc_max_temp``, ``threshold_method``, ``seed``, ``dtype``) and the run's
wall seconds (``seconds``).
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

from gpirt_tpu.campaigns import gpirt_campaigns  # noqa: E402
from gpirt_tpu.utils.datasets import senate116_response_matrix  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--campaigns", type=int, default=8)
    ap.add_argument("--chains", type=int, default=None,
                    help="chains a campaign (default: the schedule's 64)")
    ap.add_argument("--seed", type=int, default=100000)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "fixtures", "campaigns8_senate116_jax.npz"))
    args = ap.parse_args()
    if args.campaigns < 8:
        ap.error("the check needs at least 8 campaigns")

    rm, _, _ = senate116_response_matrix()
    t = time.perf_counter()
    out = gpirt_campaigns(np.asarray(rm), n_campaigns=args.campaigns,
                          n_chains=args.chains, SEED=args.seed, vote_codes=None,
                          dtype="float32", store_draws=False, verbose=True)
    seconds = time.perf_counter() - t
    sched = out["schedule"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out,
             campaign_means=out["campaign_means"][..., 0],
             theta_se=out["theta_se"][:, 0],
             theta_mean=out["theta_mean"][:, 0],
             n_campaigns=sched["n_campaigns"], n_chains=sched["n_chains"],
             sample_iterations=sched["sample_iterations"],
             burn_iterations=sched["burn_iterations"],
             smc_steps=sched["smc_steps"], smc_max_temp=sched["smc_max_temp"],
             threshold_method=sched["threshold_method"], seed=args.seed,
             dtype="float32", seconds=seconds)
    print(f"wrote {args.out}: {sched}, {seconds:.1f} s on "
          f"{jax.devices()[0].platform} ({os.cpu_count()} cores); theta SE median "
          f"{np.median(out['theta_se']):.4f}, campaign ESS median "
          f"{out['ess_campaign_median']:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
