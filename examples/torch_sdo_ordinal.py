"""Ordinal-response GP-IRT on the SDO survey with the PyTorch port (the
reference's bundled ordinal test case, data/SDO.rda; exercises the cutpoint
sampler).

The counterpart of ``examples/sdo_ordinal.py``: the same arguments,
defaults and printout, on ``gpirt_tpu_torch``.

Run:  python examples/torch_sdo_ordinal.py [--iters 1000] [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from gpirt_tpu_torch import gpirt_mcmc  # noqa: E402
from gpirt_tpu_torch.utils.datasets import load_sdo  # noqa: E402

IRF_ROWS = [300, 500, 700]  # theta = -2, 0, +2 on the 1001-point grid


def main(argv=None):
    """Runs the example; returns what it printed and what its health is
    judged by: ``cutpoints`` (m, C - 1), every item's posterior-mean
    interior cutpoints (item 1's is row 0), ``irf`` (3,), item 1's
    posterior-mean latent curve at theta = -2, 0, +2, ``theta_mean`` (n,),
    ``ll`` (S,) and ``seconds``, the wall of the gpirt_mcmc call."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--burn", type=int, default=300)
    ap.add_argument("--rows", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sdo = load_sdo()[: args.rows]
    print(f"SDO: {sdo.shape[0]} respondents x {sdo.shape[1]} items, codes 1..5")

    t = time.perf_counter()
    samples = gpirt_mcmc(
        sdo,
        sample_iterations=args.iters,
        burn_iterations=args.burn,
        vote_codes=None,  # already ordinal-coded
        store_fstar=True,
        device=args.device,
    )
    seconds = time.perf_counter() - t
    d = samples[0]
    thr = d["threshold"][..., 0]  # (S, m, C+1)
    cutpoints = thr.mean(0)[:, 1:-1]
    print("posterior-mean cutpoints, item 1:", np.round(cutpoints[0], 2))
    fstar = d["fstar"][..., 0]  # (S, N, m)
    irf = fstar.mean(axis=0)[IRF_ROWS, 0]
    print("IRF latent g(theta) for item 1 at theta = -2, 0, +2:", np.round(irf, 2))
    return {
        "cutpoints": cutpoints,
        "irf": irf,
        "theta_mean": d["theta"][:, :, 0].mean(axis=0),
        "ll": d["ll"],
        "seconds": seconds,
    }


if __name__ == "__main__":
    main()
