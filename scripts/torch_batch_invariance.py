"""Which of the port's calls round a lane otherwise when the lanes are
batched otherwise, on one CUDA card (or the CPU).

    python3 scripts/torch_batch_invariance.py [--config campaigns8] [--lanes 512]
        [--chunks 64 128 256] [--chains 64] [--device cuda] [--out batch_invariance.json]
    python3 scripts/torch_batch_invariance.py --config sdo|dynamic|two_stage|shared_irf|
        theta_ess|interleave|affine|families [--lanes 128] [--chunks 64 32 16]

With ``--config campaigns8`` (the default), at campaigns8's size (senate116,
8 campaigns of 64 chains, float32, Newton cutpoints) it runs, on ``--lanes``
lanes:

* every torch call of a short batched anneal (``anneal_init_batched``, all
  campaigns) and of three sampling sweeps under a ``TorchFunctionMode``
  that runs each call again on the last lanes (each of ``--chunks``) of its
  lane-leading arguments (a tensor whose leading axis is a multiple of the
  lanes, cut to its last share) and compares the result with the same lanes
  of the whole call's. The calls whose lanes differ are printed by the
  line of the package that made them, with their shapes and the largest
  difference. A call that mixes lanes (a resample's gather) is not lane
  sliceable and is skipped where its result's shape says so;
* ``chip_smoke.sweep_block_check``: one sweep, plain and tempered, block by
  block on all lanes and on batches of each of ``--chunks`` lanes fed the same
  inputs, every block's output compared bit for bit;
* with ``--campaigns``, phase 20's campaigns8 call in one batch against
  ``chip_smoke.campaign_blocks_reference`` (two places of four campaigns
  run in turn, phase 48's reference), every field of the result.

With a sweep family's name (``chip_smoke.FAMILY_CASES``: the ordinal SDO
sweep with ESS and Newton cutpoints, the dynamic GP theta sweep, the
two-stage sweep with both f* | f methods, the shared-IRF grid and
conjugate sweeps, ESS theta, interleave with two passes, the affine moves;
``families``: all of them), each at its chip_smoke cell's data and width,
it runs each of the family's cases on ``--lanes`` chains (128 by default):
three sweeps from the prior, then one sweep under the same
``TorchFunctionMode``, and ``chip_smoke.family_block_check``: every block
of that sweep and the whole sweep on batches of each of ``--chunks`` lanes
(64, 32 and 16 by default: a campaign, and a rank's chains on a 2- and a
4-rank chain mesh of 64), bit for bit.

Prints the card's name and power limit, then one JSON line; ``--out``
writes every differing call and block to a file.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from gpirt_tpu_torch import campaigns  # noqa: E402
from gpirt_tpu_torch.api import full_fp32_matmuls  # noqa: E402
from gpirt_tpu_torch.models.sampler import run_chains  # noqa: E402
from gpirt_tpu_torch.parallel.smc import anneal_init_batched  # noqa: E402
from gpirt_tpu_torch.utils.datasets import senate116_response_matrix  # noqa: E402

PACKAGE = os.path.join(HERE, "gpirt_tpu_torch")
# calls that move or pick values and never round: not rerun
EXACT = {"__getitem__", "__setitem__", "cat", "stack", "reshape", "view", "expand",
         "narrow", "contiguous", "clone", "repeat", "unsqueeze", "squeeze", "transpose",
         "permute", "movedim", "flatten", "to", "cpu", "cuda", "numpy", "tolist", "item",
         "__get__", "__set__", "size", "dim", "numel", "new_zeros", "new_empty",
         "new_ones", "new_full", "zeros_like", "ones_like", "empty_like", "take_along_dim",
         "index_select", "gather", "where", "expand_as", "__bool__", "__len__",
         "__iter__", "chunk", "split", "unbind", "detach", "__format__", "__repr__"}


def _callsite():
    for fr in reversed(traceback.extract_stack()[:-2]):
        if fr.filename.startswith(PACKAGE):
            return f"{os.path.relpath(fr.filename, HERE)}:{fr.lineno}"
    return "?"


class LaneCheck(TorchFunctionMode):
    """Reruns every rounding call on the last ``chunk`` of ``lanes`` lanes,
    for each of ``chunks``, and tallies by call site and chunk the calls
    whose lanes differ."""

    def __init__(self, lanes, chunks):
        super().__init__()
        self.lanes, self.chunks = lanes, tuple(chunks)
        self.sites = {}
        self.checked = 0

    def _cut(self, a, chunk):
        if torch.is_tensor(a) and a.ndim and a.shape[0] and a.shape[0] % self.lanes == 0:
            r = a.shape[0] // self.lanes
            return a[(self.lanes - chunk) * r:], True
        if isinstance(a, (list, tuple)) and a and all(torch.is_tensor(x) for x in a):
            cut = [self._cut(x, chunk) for x in a]
            return type(a)(c for c, _ in cut), any(hit for _, hit in cut)
        return a, False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        first = out[0] if isinstance(out, tuple) and out else out
        if (name in EXACT or name.endswith("_") or "generator" in kwargs or "out" in kwargs
                or not torch.is_tensor(first) or not first.ndim
                or first.shape[0] % self.lanes or not first.shape[0]):
            return out
        for chunk in self.chunks:
            self._check(func, name, args, kwargs, out, chunk)
        return out

    def _check(self, func, name, args, kwargs, out, chunk):
        cut = [self._cut(a, chunk) for a in args]
        if not any(hit for _, hit in cut):
            return
        try:
            part = func(*(c for c, _ in cut), **kwargs)
        except Exception:
            return
        if isinstance(out, tuple):  # a pair such as cholesky_ex's (L, info): each field
            for p, o in zip(part, out):
                if torch.is_tensor(o) and o.ndim and o.shape[0] % self.lanes == 0:
                    self._compare(name, args, p, o, chunk)
            return
        self._compare(name, args, part, out, chunk)

    def _compare(self, name, args, part, out, chunk):
        r = out.shape[0] // self.lanes
        want = out[(self.lanes - chunk) * r:]
        if not torch.is_tensor(part) or part.shape != want.shape:
            return
        self.checked += 1
        if torch.equal(part, want) or (part.is_floating_point()
                                      and torch.equal(torch.nan_to_num(part),
                                                      torch.nan_to_num(want))):
            return
        site = _callsite()
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        diff = (part.double() - want.double()).abs()
        rec = self.sites.setdefault((site, name, chunk), {
            "site": site, "call": name, "chunk": chunk, "shapes": shapes, "calls": 0,
            "max_abs": 0.0, "lanes_differ": 0})
        rec["calls"] += 1
        rec["max_abs"] = max(rec["max_abs"], float(torch.nan_to_num(diff).max()))
        rec["lanes_differ"] = max(rec["lanes_differ"], int(
            (diff.reshape(chunk, -1) > 0).any(1).sum()) if diff.numel() else 0)


def report_sites(sites, checked, label=""):
    for s in sites:
        print(f"differs{label}: {s['site']} {s['call']} {s['shapes']}: {s['calls']} calls, "
              f"largest {s['max_abs']:.3g}, up to {s['lanes_differ']} of {s['chunk']} lanes",
              flush=True)
    print(f"{checked} calls checked{label}, {len(sites)} call sites differ", flush=True)


def report_blocks(blocks, label=""):
    for case, res in blocks.items():
        print(f"blocks{label}, {case}: " + ", ".join(
            f"{k} {'equal' if v == 0 else f'{v:.3g} apart'}" for k, v in res.items()),
              flush=True)


def families_main(opt, dev, smi, rm):
    """The sweep families' check (module docstring), one family after
    another; prints each family's differing calls and blocks, then one
    JSON line."""
    names = chip_smoke.FAMILIES if opt.config == "families" else (opt.config,)
    lanes = opt.lanes or chip_smoke.FAMILY_LANES
    chunks = tuple(opt.chunks or chip_smoke.FAMILY_CHUNKS)
    record, summary = {}, {}
    for name in names:
        t = time.perf_counter()
        mode = LaneCheck(lanes, chunks)
        try:
            blocks = chip_smoke.family_block_check(name, rm, dev, lanes, chunks, mode=mode)
        except Exception:  # the next family still runs
            traceback.print_exc()
            summary[name] = {"failed": traceback.format_exc().splitlines()[-1]}
            continue
        sites = sorted(mode.sites.values(), key=lambda s: (s["site"], s["chunk"]))
        report_sites(sites, mode.checked, f" ({name})")
        report_blocks(blocks, f" ({name})")
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
        record[name] = {"checked": mode.checked, "sites": sites, "blocks": blocks}
        summary[name] = {"sites_differ": len(sites),
                         "blocks_differ": {k: [b for b, v in r.items() if v]
                                           for k, r in blocks.items() if any(r.values())}}
    if opt.out:
        with open(opt.out, "w") as fh:
            json.dump({"card": smi, "lanes": lanes, "chunks": chunks, "families": record},
                      fh, indent=1)
    print(json.dumps({"card": smi, "lanes": lanes, "chunks": chunks, "families": summary}))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="campaigns8",
                    choices=("campaigns8", "families") + chip_smoke.FAMILIES)
    ap.add_argument("--lanes", type=int, help="512 for campaigns8, else 128")
    ap.add_argument("--chunks", type=int, nargs="+",
                    help="64 128 256 for campaigns8, else 64 32 16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", type=int, default=64, help="chains a campaign")
    ap.add_argument("--steps", type=int, default=6, help="the short anneal's steps")
    ap.add_argument("--campaigns", action="store_true",
                    help="also campaigns8 in one batch against its places in turn")
    ap.add_argument("--out", help="a file for the whole record as JSON")
    opt = ap.parse_args()
    dev = torch.device(opt.device)
    full_fp32_matmuls()
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
    else:
        smi = "cpu"
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    rm, _, _ = senate116_response_matrix()
    if opt.config != "campaigns8":
        return families_main(opt, dev, smi, rm)
    opt.lanes = opt.lanes or 512
    opt.chunks = opt.chunks or [64, 128, 256]
    prob = campaigns._problem(np.asarray(rm), opt.lanes // opt.chains,
                              SEED=chip_smoke.CAMPAIGN_SEED, n_chains=opt.chains,
                              vote_codes=None, device=dev)
    R, K = prob.R, prob.theta_init.shape[0]
    gens = [torch.Generator(device=dev).manual_seed(prob.seed + r * K) for r in range(R)]
    mode = LaneCheck(R * K, opt.chunks)
    with mode:
        states, _ = anneal_init_batched(gens, prob.y, prob.theta_init, prob.thresholds,
                                        prob.consts, prob.config, n_steps=opt.steps,
                                        max_temp=64.0)
        run_chains(torch.Generator(device=dev).manual_seed(prob.seed + R * K), prob.y,
                   prob.theta_init.repeat(R, 1, 1), prob.thresholds, prob.consts,
                   prob.config, sample_iterations=3, burn_iterations=0,
                   initial_states=type(states)(*(a.reshape((-1,) + a.shape[2:])
                                                 for a in states)))
    sites = sorted(mode.sites.values(), key=lambda s: (s["site"], s["chunk"]))
    report_sites(sites, mode.checked)
    blocks = {f"{label}, batches of {chunk}": res for chunk in opt.chunks
              for label, res in chip_smoke.sweep_block_check(prob, opt.lanes, chunk).items()}
    report_blocks(blocks)
    camp = {}
    if opt.campaigns:
        from gpirt_tpu_torch import gpirt_campaigns

        t = time.perf_counter()
        whole = gpirt_campaigns(np.asarray(rm), SEED=chip_smoke.CAMPAIGN_SEED,
                                n_campaigns=chip_smoke.CAMPAIGNS, vote_codes=None,
                                store_draws=False, verbose=False, device=dev)
        places = chip_smoke.campaign_blocks_reference(rm, dev)
        camp = {k: bool(np.array_equal(np.asarray(whole[k]), np.asarray(places[k])))
                for k in chip_smoke.CAMPAIGN_FIELDS}
        # the anneal's states and the sampling draws, whole against the places
        cprob = campaigns._problem(np.asarray(rm), chip_smoke.CAMPAIGNS,
                                   SEED=chip_smoke.CAMPAIGN_SEED, vote_codes=None, device=dev)
        cK = cprob.theta_init.shape[0]

        def anneal(shards):
            g = [torch.Generator(device=dev).manual_seed(cprob.seed + r * cK)
                 for r in range(cprob.R)]
            return anneal_init_batched(g, cprob.y, cprob.theta_init, cprob.thresholds,
                                       cprob.consts, cprob.config,
                                       n_steps=cprob.sched["smc_steps"],
                                       max_temp=cprob.sched["smc_max_temp"], shards=shards)

        from gpirt_tpu_torch.parallel.chains import Shards

        st_w, _ = anneal(None)
        st_p = [anneal(Shards(2, r))[0] for r in range(2)]
        for f, a in zip(st_w._fields, st_w):
            b = torch.cat([getattr(p, f) for p in st_p])
            camp[f"anneal_{f}"] = bool(torch.equal(a, b))
        d_w = campaigns._campaign_draws(cprob, None)[1]
        d_p = [campaigns._campaign_draws(cprob, Shards(2, r))[1] for r in range(2)]
        for k, a in d_w.items():
            camp[f"draws_{k}"] = bool(torch.equal(a, torch.cat([p[k] for p in d_p])))
        print(f"campaigns8 in one batch against 2 places of 4 campaigns in turn "
              f"({time.perf_counter() - t:.1f} s): "
              + ", ".join(f"{k} {'equal' if v else 'differs'}" for k, v in camp.items()),
              flush=True)
    line = {"card": smi, "lanes": opt.lanes, "chunks": opt.chunks, "checked": mode.checked,
            "sites": sites, "blocks": blocks, "campaigns": camp}
    if opt.out:
        with open(opt.out, "w") as fh:
            json.dump(line, fh, indent=1)
    print(json.dumps({"card": smi, "sites_differ": len(sites),
                      "blocks_differ": {k: [b for b, v in r.items() if v]
                                        for k, r in blocks.items()},
                      "campaign_fields_differ": [k for k, v in camp.items() if not v]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
