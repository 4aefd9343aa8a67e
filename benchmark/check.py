"""The comparison that decides ``correct``: the reference follows the
program, from the program's own state at a sweep, through that sweep with
the same random numbers, and judges the draws the host received for it.

The reference is the plain sweep that the configuration names
(``reference/<name>.py``); it runs in float64 on the card, after the
window has closed and the program's state is freed. A snapshot holds the
state a sweep started from and the program's generator there; the
reference takes its numbers from a copy of that generator in the
program's draw order. Each block after a draw takes the program's own
result of that draw (as the host received it), so that a near-tie in one
discrete choice does not carry into the next block; the reference module
says what it compares (its ``NUMBERS``). Two sweeps are judged: the
window's first, handed over from set-up, and one more run after the
window has closed, through the same objects, from where the window left
the chains. A cell compares the numbers that its
``limits/<workload>.json`` names, each the widest over the judged sweeps.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


class Replay:
    """The reference's view of a cell: its module, the model's settings,
    the categories and the constants, on ``device``."""

    def __init__(self, ref, cfg: dict, y: np.ndarray, C: int, device):
        self.ref, self.C, self.device = ref, C, torch.device(device)
        self.model = dict(cfg["program"], beta_prior_sd=cfg["beta_prior_sd"])
        self.y = torch.as_tensor(y, device=self.device)
        self.n, self.m = y.shape
        self.consts = {}

    def k(self, dtype):
        if dtype not in self.consts:
            self.consts[dtype] = self.ref.constants(self.model, self.m, self.device, dtype)
        return self.consts[dtype]

    def sweep(self, snap: dict, dtype, given=None):
        """The reference's sweep from ``snap`` in ``dtype``; ``given`` (the
        program's draws) taken in its later blocks."""
        gen = torch.Generator(device=self.device)
        gen.set_state(snap["gen"])
        state = snap["state"]
        K = next(iter(state.values())).shape[0]
        d = self.ref.draws(gen, self.model, K, self.n, self.m, self.C)

        def to(src):
            return None if src is None else {
                k: v.to(self.device, dtype if v.is_floating_point() else None)
                for k, v in src.items()}
        return self.ref.sweep(to(state), d, self.y, self.C, self.k(dtype), to(given))

    def judge(self, snap: dict, given: dict):
        """(numbers, the reference's output) of one sweep: the float64
        reference against ``given``."""
        out, _ = self.sweep(snap, torch.float64, given)
        return self.ref.numbers(out, given), out

    def control(self, snap: dict) -> dict:
        """The control: the reference in the program's place, in float32 with
        TF32 products, judged as the program is."""
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            out, _ = self.sweep(snap, torch.float32)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return self.judge(snap, self.ref.as_given(out))[0]


def snapshot(ref, state, gen: torch.Generator) -> dict:
    """The program's state a sweep starts from and its generator's state,
    on the host."""
    return {"gen": gen.get_state(), "state": ref.snapshot(state)}


def judge_sweeps(replay: Replay, sweeps: List[tuple], limits: dict, control: bool = False,
                 faults: Dict[str, object] = None) -> dict:
    """Judge ``sweeps``, each (snapshot, the program's record of that sweep
    as the host received it). Returns the numbers (the widest over the
    sweeps), the sweeps judged and failed, each sweep's numbers, the
    cutpoint update's proposal counts of the first sweep (for the kernel's
    roofline), and when asked for the control's numbers and those of each
    fault of ``faults`` (a name and a function that alters a given)."""
    numbers = replay.ref.NUMBERS
    per_sweep, ctrl, planted, rounds = [], [], {f: [] for f in faults or ()}, None
    for snap, rec in sweeps:
        given = replay.ref.given_of(rec, replay.model)
        nums, out = replay.judge(snap, given)
        per_sweep.append(nums)
        if rounds is None:
            rounds = (out.rounds.cpu().numpy(), out.capped.cpu().numpy())
        if control:
            ctrl.append(replay.control(snap))
        for f, alter in (faults or {}).items():
            planted[f].append(replay.judge(snap, alter(dict(given)))[0])

    def worst(rows):
        return {k: max((p[k] for p in rows), default=math.nan) for k in numbers}
    failed = sum(any(not p[k] <= lim for k, lim in limits.items()) for p in per_sweep)
    out = {"numbers": worst(per_sweep), "judged": len(per_sweep), "failed": failed,
           "per_sweep": per_sweep, "rounds": rounds}
    if control:
        out["control"] = worst(ctrl)
    if faults:
        out["faults"] = {f: worst(rows) for f, rows in planted.items()}
    return out
