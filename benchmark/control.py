"""The readings that the limits of ``limits/<workload>.json`` are set from,
on the card at the cell's own size, all seeds in one process:

    python3 benchmark/control.py --workload <name> --seeds 1 2 ... --control 3 --seconds 4

For each seed a run with a short window, and the check's numbers of the
program (the lower reading: the largest of these over the seeds); for the
first ``--control`` seeds also the control's, the reference in the
program's place in float32 with TF32 products, and those of each fault the
reference module plants in the program's draws (``PLANTED``: an answer
altered where it is produced); the upper reading of a number is the
smallest of these. One JSON line a seed, then a summary line.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the host's share of a run is the sweep's
# dispatch, and idle OpenMP and BLAS threads only add to its spread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.cells import load_cell, load_module
    from benchmark.harness import run_cell

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    ref = load_module("reference", cell.config["reference"])
    names = ref.NUMBERS
    kinds = ["control"] + list(ref.PLANTED)
    lows, highs = {k: [] for k in names}, {f: {k: [] for k in names} for f in kinds}
    t0 = T0
    for i, seed in enumerate(args.seeds):
        ctl = i < args.control
        run = run_cell(cell, seed, args.seconds, False, "cuda", t0, control=ctl,
                       faults=ref.PLANTED if ctl else None)
        t0 = time.perf_counter()
        v = run["verdict"]
        line = {"workload": cell.name, "seed": seed, "judged": v["judged"],
                "program": v["numbers"], "control": v.get("control"),
                "faults": v.get("faults"), "sweeps_per_s": run["sweeps"] / run["window_s"],
                "setup_s": run["setup_s"]}
        print(json.dumps(line), flush=True)
        for k in names:
            lows[k].append(v["numbers"][k])
            if ctl:
                highs["control"][k].append(v["control"][k])
                for f in ref.PLANTED:
                    highs[f][k].append(v["faults"][f][k])
    clean = lambda xs: [x for x in xs if not math.isnan(x)]
    print(json.dumps({"workload": cell.name, "seeds": len(args.seeds),
                      "lower": {k: max(clean(lows[k]), default=None) for k in names},
                      "upper": {f: {k: min(clean(highs[f][k]), default=None) for k in names}
                                for f in kinds}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
