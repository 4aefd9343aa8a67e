"""A whole run of the harness on the CPU at a tiny size (its look for a
card skipped), with the timed path broken underneath: each fault the cells
can have makes ``correct`` false, and the sound run is correct. The faults:
a sweep that returns its state, half of the chains left out of the sweep,
and an answer altered where it is produced (a beta where the draw is
recorded, a theta where it is drawn, the cutpoints where the binary kernel
or the ordinal ESS returns them, the log-likelihood where the sweep
returns it). The cells run on one card, so there is no exchange between
chips to leave out."""

import pytest
import torch

import gpirt_tpu_torch.models.gibbs as gibbs
import gpirt_tpu_torch.models.sampler as sampler
from benchmark import harness
from benchmark.run import checks_of
from gpirt_tpu_torch.models.gibbs import GPIRTState

WORKLOADS = ("senate116-k64", "sdo-k64")


def unchanged(real):
    """The sweep returns the state it was given."""
    def sweep(state, *args, **kw):
        return state, real(state, *args, **kw)[1]
    return sweep


def half_batch(real):
    """The second half of the chains is left out of the sweep."""
    def sweep(state, *args, **kw):
        new, ll = real(state, *args, **kw)
        h = state.theta_idx.shape[0] // 2
        return GPIRTState(*(torch.cat([a[:h], b[h:]]) for a, b in zip(new, state))), ll
    return sweep


def altered(real):
    """One beta of one chain altered where the draw is recorded."""
    def record(*args, **kw):
        out = dict(real(*args, **kw))
        beta = out["beta"].clone()
        beta[0, 0, 1, 0] += 0.05
        out["beta"] = beta
        return out
    return record


def theta_moved(real):
    """Chain 0's theta one grid point off where it is drawn."""
    def draw(*args, **kw):
        idx = real(*args, **kw).clone()
        idx[0] = torch.where(idx[0] > 0, idx[0] - 1, idx[0] + 1)
        return idx
    return draw


def cut_moved(real):
    """Chain 0's cutpoint update off by 0.01 where it returns."""
    def update(*args, **kw):
        out = real(*args, **kw).clone()
        out[0] += 0.01
        return out
    return update


def ll_scaled(real):
    """Chain 0's log-likelihood 1e-3 of itself off where the sweep returns it."""
    def sweep(*args, **kw):
        state, ll = real(*args, **kw)
        ll = ll.clone()
        ll[0] *= 1.0 + 1e-3
        return state, ll
    return sweep


# fault -> (module, function, wrapper, the workloads whose sweep runs it)
FAULTS = {"sound": None,
          "unchanged": (sampler, "gibbs_sweep", unchanged, WORKLOADS),
          "half_batch": (sampler, "gibbs_sweep", half_batch, WORKLOADS),
          "altered": (sampler, "draw_record", altered, WORKLOADS),
          "theta": (gibbs, "draw_theta", theta_moved, WORKLOADS),
          "kernel": (gibbs, "binary_threshold_ess", cut_moved, ("senate116-k64",)),
          "ordinal_ess": (gibbs, "ess_update", cut_moved, ("sdo-k64",)),
          "ll": (sampler, "gibbs_sweep", ll_scaled, WORKLOADS)}
CASES = [(w, f) for f, spec in FAULTS.items() for w in WORKLOADS
         if spec is None or w in spec[3]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_makes_the_run_incorrect(workload, fault, tiny, monkeypatch):
    torch.set_num_threads(1)
    if FAULTS[fault] is not None:
        module, name, wrap, _ = FAULTS[fault]
        monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    run = harness.run_cell(tiny(workload), 2 ** 31 + 11, 1.0, False, "cpu")
    correct, checks = checks_of(run)
    assert run["verdict"]["judged"] >= 1
    assert correct == (fault == "sound"), (fault, checks)
