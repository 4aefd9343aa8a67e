"""The reference against the port on the CPU: one sweep of each
configuration at a tiny size from the same state and the same numbers.
In float64 the two agree to rounding; the numbers the reference takes
from a copy of the generator are the port's own."""

import numpy as np
import pytest
import torch

from benchmark.cells import load_data, load_module
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.models.gibbs import gibbs_sweep, init_draws, init_state, sweep_draws
from gpirt_tpu_torch.utils.response import (DEFAULT_VOTE_CODES, as_response_matrix,
                                            encode_categories)

CASES = {"senate116": dict(dataset="senate116", vote_codes="voteview", rows=20, cols=30,
                           jitter=1e-4),
         "sdo": dict(dataset="sdo", vote_codes=None, rows=40, cols=16, jitter=1e-6)}
N = 101
ref = load_module("reference", "conjugate_grid")


def port_run(case, dtype, K=4, sweeps=2, seed=5):
    """The port's state after ``sweeps`` sweeps, then its next sweep with
    the generator state it started from."""
    raw, y, C = load_data(case)
    data = as_response_matrix(raw, DEFAULT_VOTE_CODES, verbose=False) \
        if case["vote_codes"] else raw
    yy, _, _ = encode_categories(np.asarray(data, np.float64))
    _, n, m = yy.shape
    config = GPIRTConfig(n=n, m=m, C=C, dtype=dtype, jitter=case["jitter"], grid_size=N)
    consts = make_constants(config, np.zeros((3, m)), np.full((3, m), 3.0),
                            np.zeros((2, n)), np.zeros((2, n)), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    inits = np.stack([np.random.default_rng(k).permutation(np.linspace(-2, 2, n))[None]
                      for k in range(K)])
    st = init_state(torch.as_tensor(inits, dtype=config.tdtype),
                    torch.as_tensor(default_thresholds(C, m, 1), dtype=config.tdtype),
                    consts, config, init_draws(gen, K, consts, config))
    yt = torch.as_tensor(yy, dtype=torch.int32)
    for it in range(sweeps):
        st, _ = gibbs_sweep(st, sweep_draws(gen, K, consts, config, it), yt, consts, config,
                            None, it)
    start = torch.Generator()
    start.set_state(gen.get_state())
    d = sweep_draws(gen, K, consts, config, sweeps)
    new, ll = gibbs_sweep(st, d, yt, consts, config, None, sweeps)
    return dict(y=y, C=C, consts=consts, state=st, start=start, draws=d, new=new, ll=ll,
                model={"grid_size": N, "beta_prior_sd": 3.0, "jitter": case["jitter"],
                       "ess_max_rounds": config.ess_max_rounds})


def state_of(st, dtype=torch.float64):
    return {"theta_idx": st.theta_idx[:, 0], "beta": st.beta[:, 0].to(dtype),
            "thresholds": st.thresholds[:, 0].to(dtype), "fstar": st.fstar[:, 0].to(dtype)}


@pytest.mark.parametrize("name", CASES)
def test_draws_are_the_ports(name):
    r = port_run(CASES[name], "float32")
    K, n, m = r["state"].f.shape[0], r["y"].shape[0], r["y"].shape[1]
    d = ref.draws(r["start"], r["model"], K, n, m, r["C"])
    p = r["draws"]
    pairs = {"u_theta": p.u_theta, "u_z": p.u_z[:, 0], "z_q": p.z_q[:, 0], "z_p": p.z_p[:, 0],
             "z_n": p.z_n[:, 0], "eps_f": p.eps_f[:, 0], "zeta": p.zeta[:, 0],
             "nu": p.cut.nu[:, 0], "logu": p.cut.logu[:, 0], "eps0": p.cut.eps0[:, 0],
             "rs": p.cut.rs[:, :, 0]}
    for k, v in pairs.items():
        assert torch.equal(d[k], v), k


@pytest.mark.parametrize("name", CASES)
def test_constants_are_worked_out_again(name):
    r = port_run(CASES[name], "float64", sweeps=0)
    k = ref.constants(r["model"], r["y"].shape[1], "cpu", torch.float64)
    assert torch.equal(k.U_grid[:, :32], r["consts"].U_se)
    assert torch.equal(k.U_grid[:, 32:], r["consts"].Psi_grid)
    assert torch.equal(k.grid, r["consts"].grid)


@pytest.mark.parametrize("name", CASES)
def test_one_sweep_float64(name):
    r = port_run(CASES[name], "float64")
    k = ref.constants(r["model"], r["y"].shape[1], "cpu", torch.float64)
    K = r["state"].f.shape[0]
    n, m = r["y"].shape
    d = ref.draws(r["start"], r["model"], K, n, m, r["C"], dtype=torch.float64)
    out, nxt = ref.sweep(state_of(r["state"]), d, torch.as_tensor(r["y"]), r["C"], k)
    new = r["new"]
    assert torch.equal(out.theta_idx, new.theta_idx[:, 0])
    torch.testing.assert_close(out.beta, new.beta[:, 0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(out.thresholds, new.thresholds[:, 0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(out.ll, r["ll"], rtol=1e-12, atol=0)
    torch.testing.assert_close(nxt["fstar"], new.fstar[:, 0], rtol=1e-9, atol=1e-9)
    assert float(out.theta_gap.max()) == 0.0


@pytest.mark.parametrize("name", CASES)
def test_judging_the_port_float32(name):
    """The float32 port judged by the float64 reference: theta at
    rounding level; beta within float32's reach at 20 sites an item, where
    one latent z drawn at the edge of its truncation (float32 resolves a
    normal CDF near 1 to ~6e-8) moves an item's regression by ~1e-3."""
    r = port_run(CASES[name], "float32")
    k = ref.constants(r["model"], r["y"].shape[1], "cpu", torch.float64)
    K = r["state"].f.shape[0]
    n, m = r["y"].shape
    d = ref.draws(r["start"], r["model"], K, n, m, r["C"])
    new = r["new"]
    given = {"theta_idx": new.theta_idx[:, 0], "beta": new.beta[:, 0].double(),
             "thresholds": new.thresholds[:, 0].double()}
    out, _ = ref.sweep(state_of(r["state"]), d, torch.as_tensor(r["y"]), r["C"], k, given)
    assert float(out.theta_gap.max()) < 1e-3
    gap = (given["beta"] - out.beta).abs() / (1 + out.beta.abs())
    assert float(gap.max()) < 1e-2 and float(gap.median()) < 1e-5
    assert float(out.cut_gap.max()) < 1e-2


def test_ess_margin_reads_a_parted_lane():
    """A lane whose target took a proposal the reference rejected reads the
    reference's shortfall there; agreeing lanes read 0."""
    x = torch.zeros(2, 1, dtype=torch.float64)
    nu = torch.ones(2, 1, dtype=torch.float64)
    logu = torch.full((2,), -0.5, dtype=torch.float64)
    eps0 = torch.full((2,), 1.0, dtype=torch.float64)
    rs = torch.full((4, 2), 0.5, dtype=torch.float64)

    def loglik(v):  # accepts |v| < 0.5: the first proposal sin(1) = 0.84 is rejected
        return torch.where(v[..., 0].abs() < 0.5, 0.0, -1.0).to(torch.float64)

    new, rounds, capped, _ = ref.ess(x, nu, loglik, logu, eps0, rs)
    target = new.clone()
    target[1, 0] = torch.sin(torch.tensor(1.0, dtype=torch.float64))  # took round 1's
    _, _, _, margin = ref.ess(x, nu, loglik, logu, eps0, rs, target)
    assert margin[0] == 0.0 and margin[1] == pytest.approx(0.5)
