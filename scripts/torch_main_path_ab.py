"""The main path (senate116 through gpirt_mcmc: 64 chains, float32, 320 SMC
steps from T = 64, burn 100, 500 draws) with this checkout's
gpirt_tpu_torch against another tree's, on one CUDA card, in turns.

    python3 scripts/torch_main_path_ab.py --other DIR [--rounds 2] [--config main_verbose|campaigns8]
    python3 scripts/torch_main_path_ab.py --other DIR --config families [--chains 64]

``--config main_verbose`` runs the main call at ``gpirt_mcmc``'s default
``verbose=True``: progress every ``chunk_iterations`` sweeps, the summaries
on stderr. ``--config campaigns8`` runs chip_smoke's phase 20 instead
(gpirt_campaigns on senate116, 8 campaigns of 64 chains, one warm call,
then the timed one) and compares its batch wall; each side's campaign
means must repeat (their sha256), and may differ from the other side's.
``--config families`` runs each sweep family of chip_smoke.py's phases 51-52
(``chip_smoke.FAMILIES``, at its cell: ``chip_smoke.family_run``) at
``--chains`` chains, burn 20 and 100 draws, and compares each family's
sampling sweeps a second; the data and calls come from this checkout's
chip_smoke.py, the package from the run's own root; each side must repeat
its draws (at 64 chains a lane-chunked call is the whole call, so both sides
should draw the same).

DIR is the root of another checkout (for example a parent commit unpacked
with ``git archive`` into a gitignored directory). Each run is a process of
its own that imports the package from one root only and builds its kernel
there; the order is other, this, this, other, repeated ``--rounds`` times.
Prints the card's name and power limit, each run's SMC and sampling
sweeps a second and the sha256 of its draws (theta, beta, threshold, ll,
chain by chain), then one JSON line: the medians, the spread of each
side's sampling rate, and whether every run drew the same.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One run, in a process whose sys.path starts at the root given as argv[1].
RUN = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.parallel.smc import WARM_STEPS
from gpirt_tpu_torch.utils.datasets import senate116_response_matrix

rm, _, _ = senate116_response_matrix()
out = gpirt_mcmc(rm, 500, 100, CHAIN=64, SEED=1, smc_steps=320, smc_max_temp=64.0,
                 dtype="float32", device="cuda", verbose=False)
h = hashlib.sha256()
for d in out:
    for k in ("theta", "beta", "threshold", "ll"):
        h.update(np.ascontiguousarray(d[k]).tobytes())
s = out[0]["seconds"]
print(json.dumps({"sha256": h.hexdigest(), "smc_sweeps_per_s": (WARM_STEPS + 319) / s["smc"],
                  "sampling_sweeps_per_s": 600 / s["sampling"]}))
"""


# phase 20 (chip_smoke.py's campaigns8), one run, as RUN is
RUN_CAMPAIGNS = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from gpirt_tpu_torch import gpirt_campaigns
from gpirt_tpu_torch.utils.datasets import senate116_response_matrix

rm, _, _ = senate116_response_matrix()
kw = dict(n_campaigns=8, vote_codes=None, store_draws=False, verbose=False, device="cuda")
gpirt_campaigns(np.asarray(rm), SEED=990001, **kw)
out = gpirt_campaigns(np.asarray(rm), SEED=100000, **kw)
w = out["walls"]
print(json.dumps({"sha256": hashlib.sha256(np.ascontiguousarray(out["campaign_means"])
                                           .tobytes()).hexdigest(),
                  "batch_wall_s": w["total_sec"], "smc_s": w["smc_sec"],
                  "sampling_s": w["sampling_sec"]}))
"""

# each sweep family's cell (chip_smoke.family_run), one run, as RUN is; the
# package is imported from argv[1] before chip_smoke.py from this checkout
RUN_FAMILIES = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import gpirt_tpu_torch
import torch
sys.path.append(sys.argv[2])
import chip_smoke
from gpirt_tpu_torch.ops import threshold_ess
from gpirt_tpu_torch.utils.datasets import senate116_response_matrix

threshold_ess.build()  # the kernel built before any family is timed
rm, _, _ = senate116_response_matrix()
size = dict(chains=int(sys.argv[3]), burn=20, draws=100)
h, out = hashlib.sha256(), {}
for name in chip_smoke.FAMILIES:
    sha, secs = chip_smoke.family_run(chip_smoke.family_call(name, rm), torch.device("cuda"),
                                      size)
    h.update(sha.encode())
    out[f"{name}_sweeps_per_s"] = (size["burn"] + size["draws"]) / secs
out["sha256"] = h.hexdigest()
print(json.dumps(out))
"""
CONFIGS = {"main": (RUN, "sampling_sweeps_per_s"),
           # the main call at gpirt_mcmc's default verbose=True: the run
           # advances chunk_iterations sweeps at a time and prints progress
           "main_verbose": (RUN.replace("verbose=False", "verbose=True"),
                            "sampling_sweeps_per_s"),
           "campaigns8": (RUN_CAMPAIGNS, "batch_wall_s"),
           "families": (RUN_FAMILIES, None)}


def run(root, config="main", chains=64):
    extra = [HERE, str(chains)] if config == "families" else []
    proc = subprocess.run([sys.executable, "-c", CONFIGS[config][0], os.path.abspath(root),
                           *extra], capture_output=True, text=True, check=True, timeout=900)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="main")
    ap.add_argument("--chains", type=int, default=64, help="--config families' chains")
    opt = ap.parse_args()
    key = CONFIGS[opt.config][1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    runs = {"other": [], "this": []}
    for _ in range(opt.rounds):
        for side in ("other", "this", "this", "other"):
            r = run(opt.other if side == "other" else HERE, opt.config, opt.chains)
            runs[side].append(r)
            print(f"{side}: " + ", ".join(f"{k} {v:.3f}" for k, v in r.items()
                                          if k != "sha256") + f", sha256 {r['sha256']}",
                  flush=True)
    summary = {"card": smi, "config": opt.config}
    keys = [key] if key else [k for k in runs["this"][0] if k != "sha256"]
    for side, rs in runs.items():
        summary[side] = {}
        for k in keys:
            vals = [r[k] for r in rs]
            summary[side].update({f"{k}_median": statistics.median(vals), f"{k}_min": min(vals),
                                  f"{k}_max": max(vals)})
        if opt.config.startswith("main"):
            summary[side]["smc_median"] = statistics.median(r["smc_sweeps_per_s"]
                                                            for r in rs)
    summary["same_draws"] = len({r["sha256"] for rs in runs.values() for r in rs}) == 1
    summary["each_side_repeats"] = all(len({r["sha256"] for r in rs}) == 1
                                       for rs in runs.values())
    print(json.dumps(summary))
    # the main path must draw what the other tree draws; campaigns8's means
    # and the families' draws may move with a change, but each side must repeat
    ok = (summary["same_draws"] if opt.config.startswith("main")
          else summary["each_side_repeats"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
