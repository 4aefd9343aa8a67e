"""The benchmark of gpirt_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's sweeps), ``failed`` (the judged sweeps that
broke a limit), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers close standard error. Without a card, or with fewer than
the cell asks for, it prints no result and exits 2; if JAX or the JAX
package was loaded, it exits 3.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# kept out of the run: JAX, its libraries, and the JAX package (the port's
# name begins with its name, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpirt_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metrics_of(run: dict, entries: list) -> dict:
    """Each metric whose reader finds something to read, with its unit."""
    from benchmark.cells import load_module

    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _finite(x: float):
    """A number for JSON: None for nan, the largest float for inf."""
    return None if math.isnan(x) else math.copysign(sys.float_info.max, x) \
        if math.isinf(x) else x


def checks_of(run: dict) -> tuple:
    """(correct, {number: {value, limit}}) of a run: every judged sweep
    within every limit of the cell, at least one sweep judged, and the
    program's coding of the data the benchmark's own."""
    verdict, limits = run["verdict"], run["cell"].limits
    checks = {k: {"value": _finite(verdict["numbers"][k]), "limit": lim}
              for k, lim in limits.items()}
    correct = (verdict["same_data"] and verdict["judged"] > 0 and verdict["failed"] == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    return bool(correct), checks


def result_of(run: dict, trace: bool, kind: str) -> dict:
    """The result line of a run on a card named ``kind``."""
    cell = run["cell"]
    correct, checks = checks_of(run)
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": run["sweeps"], "failed": run["verdict"]["failed"],
           "metrics": metrics_of(run, cell.per_layer if trace else cell.end_to_end),
           "device": device}
    if trace and run["trace"] is not None:
        device.update(busy_s=run["trace"].busy_s, window_s=run["trace"].window_s)
        out["breakdown"] = {"device_ops": run["trace"].device_ops,
                            "idle_gaps": run["trace"].idle_gaps}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.cells import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    from benchmark.harness import run_cell

    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"[bench] the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out = result_of(run, bool(args.trace), torch.cuda.get_device_name(0))
    others = {k: v for k, v in run["verdict"]["numbers"].items() if k not in cell.limits}
    print(f"[bench] not compared: {others}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
