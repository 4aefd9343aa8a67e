"""Port tests that need the card: the CUDA kernel against its plain version,
over shapes (every thread-group size the kernel chooses from n), edge cases
and one c a chain; whole sweeps on the card against the same sweeps on the
CPU (binary, ordinal with the cutpoints by ESS and by Newton, over three
sessions in the GP theta regime, with one temperature a chain, the
two-stage sampler with f* by both methods, and the grid sampler with one
IRF shared by the sessions and without, the ESS theta update in the three
regimes, the affine moves untempered and with one temperature a chain);
the kernel at the pooled constant_IRF layout; and gpirt_mcmc (tempered too),
gpirt_campaigns, recover_fstar and recover_fstar_batch on the card by
default.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
This file imports no JAX (nor does chip_smoke.py, whose sweep inputs it
shares), so on a machine with an NVIDIA GPU and nvcc but no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gpirt_tpu_torch import gpirt_mcmc
from gpirt_tpu_torch.models import gibbs
from gpirt_tpu_torch.models.config import make_constants
from gpirt_tpu_torch.ops.threshold_ess import (
    binary_threshold_ess,
    binary_threshold_ess_reference,
)

_C = 0.7071067811865476
_TWO_PI = 6.283185307179586


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


def _lane_inputs(device, K=4, H=1, n=50, m=97, R=64, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((K, H, n, m))
    y = rng.choice([0, 1, 2], size=(H, n, m), p=[0.2, 0.4, 0.4])
    t1, nu = rng.standard_normal((2, K, H, m))
    logu = np.log(rng.random((K, H, m)))
    eps0 = rng.random((K, H, m)) * _TWO_PI
    rs = rng.random((R, K, H, m))
    f32 = [torch.as_tensor(a, dtype=torch.float32, device=device)
           for a in (g, t1, nu, logu, eps0, rs)]
    return [f32[0], torch.as_tensor(y, dtype=torch.int32, device=device)] + f32[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("temp", [1.0, 64.0])
def test_kernel_matches_plain_version(cuda_device, temp):
    """float32 on the card: every lane within 1e-5 except at most 1% of
    lanes whose accept flipped on a near-tie (the kernel sums the sites in
    another order than torch.sum)."""
    args = _lane_inputs(cuda_device)
    c = _C / np.sqrt(temp)
    before = binary_threshold_ess.launches
    got = binary_threshold_ess(*args, c)
    torch.cuda.synchronize()
    assert binary_threshold_ess.launches == before + 1
    want = binary_threshold_ess_reference(*args, c)
    err = (got - want).abs()
    assert int((err > 1e-5).sum()) <= 0.01 * err.numel()
    assert float((got != args[2]).float().mean()) > 0.8  # lanes moved


def _assert_matches_plain(got, want):
    """The kernel's rule on the card: at most 0.1% of lanes over 1e-5. A
    lane over it is a near-tie accept that flipped: the kernel sums a lane's
    sites in another order than torch.sum, and nothing else differs."""
    err = (got - want).abs()
    over = int((err > 1e-5).sum())
    assert over <= 0.001 * err.numel(), (over, err.numel(), float(err.max()))
    assert bool(torch.isfinite(got).all())
    return err


@pytest.mark.gpu
@pytest.mark.parametrize("temp", [1.0, 64.0])
@pytest.mark.parametrize("H", [1, 3])
@pytest.mark.parametrize("m", [97, 418])
@pytest.mark.parametrize("n", [1, 31, 33, 100, 200, 257, 5000])
def test_kernel_over_shapes(cuda_device, n, m, H, temp):
    """Every path the kernel chooses from n (8 threads a lane up to n = 32,
    a warp up to 256, a block of registers up to 2048, streaming beyond),
    unaligned m, several sessions, and items with no observed response."""
    args = _lane_inputs(cuda_device, K=16, H=H, n=n, m=m, seed=n + m + H)
    args[1][:, :, 0] = 0  # item 0: no response in any session
    args[1][0, :, 1] = 0  # item 1: none in session 0
    c = _C / np.sqrt(temp)
    before = binary_threshold_ess.launches
    got = binary_threshold_ess(*args, c)
    torch.cuda.synchronize()
    assert binary_threshold_ess.launches == before + 1
    want = binary_threshold_ess_reference(*args, c)
    err = _assert_matches_plain(got, want)
    # ll is 0 on an all-missing lane, so its first proposal is taken
    assert float(err[:, :, 0].max()) <= 1e-5
    assert float(err[:, 0, 1].max()) <= 1e-5
    assert bool((got[:, :, 0] != args[2][:, :, 0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("temp", [1.0, 64.0])
@pytest.mark.parametrize("R", [1, 2])
def test_kernel_round_cap_keeps_t0(cuda_device, R, temp):
    """With a cap of R rounds, a lane not accepted by then keeps t0 bit for
    bit, as in the plain version."""
    args = _lane_inputs(cuda_device, K=16, n=100, m=418, R=R, seed=R)
    c = _C / np.sqrt(temp)
    got = binary_threshold_ess(*args, c)
    want = binary_threshold_ess_reference(*args, c)
    err = _assert_matches_plain(got, want)
    kept = want == args[2]
    assert 0 < int(kept.sum()) < kept.numel()
    agree = kept & (err <= 1e-5)
    assert torch.equal(got[agree], args[2][agree])


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    args = _lane_inputs(cuda_device)
    with pytest.raises(ValueError, match="float32"):
        binary_threshold_ess(*[a.double() if a.is_floating_point() else a
                               for a in args], _C)
    with pytest.raises(ValueError, match="int32"):
        binary_threshold_ess(args[0], args[1].long(), *args[2:], _C)
    with pytest.raises(ValueError, match="contiguous"):
        binary_threshold_ess(args[0].mT.contiguous().mT, *args[1:], _C)


def _sweep_on_both(device, C=2, method="auto", temp=4.0, H=1, theta_ls=10.0):
    """One float32 sweep from the same state and draws on the CPU and on
    ``device`` (chip_smoke.py's sweep inputs; over sessions y is drawn from
    the model at one state shared by the chains): theta identical, the
    rest within 1e-3 (float32 products and solves in another order)."""
    cfg, priors, state0, draws, y = chip_smoke.sweep_inputs(C, method, H, theta_ls)
    cpu = torch.device("cpu")
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, device)}
    out = {}
    for d in (cpu, device):
        out[d] = gibbs.gibbs_sweep(
            gibbs.GPIRTState(*(a.to(d) for a in state0)),
            draws.to(d),
            torch.as_tensor(y, device=d), consts[d], cfg,
            temp=temp.to(d) if torch.is_tensor(temp) else temp)
    (s_cpu, ll_cpu), (s_gpu, ll_gpu) = out[cpu], out[device]
    assert torch.equal(s_cpu.theta_idx, s_gpu.theta_idx.cpu())
    for a, b in zip(s_cpu[1:], s_gpu[1:]):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(ll_gpu.cpu(), ll_cpu, rtol=1e-4, atol=1e-3)
    return state0, s_gpu


@pytest.mark.gpu
def test_sweep_on_card_matches_cpu(cuda_device):
    """A tempered binary sweep (T = 4), its cutpoints by the kernel."""
    before = binary_threshold_ess.launches
    _sweep_on_both(cuda_device)
    assert binary_threshold_ess.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("temp", [None, 64.0])
@pytest.mark.parametrize("method", ["ess", "newton"])
def test_ordinal_sweep_on_card_matches_cpu(cuda_device, method, temp):
    """A C = 5 sweep at T = 1 and 64, its cutpoints by the ordinal ESS or
    by Newton-proposal MH; the binary kernel is not launched."""
    before = binary_threshold_ess.launches
    state0, state = _sweep_on_both(cuda_device, C=5, method=method, temp=temp)
    assert binary_threshold_ess.launches == before
    t = state.thresholds[..., 1:-1]
    assert bool((t[..., 1:] > t[..., :-1]).all())
    assert bool((state.thresholds != state0.thresholds.to(t.device)).any())


@pytest.mark.gpu
@pytest.mark.parametrize("C", [2, 5])
def test_gp_sweep_on_card_matches_cpu(cuda_device, C):
    """A tempered sweep over three sessions in the GP theta regime (theta_ls
    = 2): the sequential session draws agree; at C = 2 the kernel runs once."""
    before = binary_threshold_ess.launches
    state0, state = _sweep_on_both(cuda_device, C=C, H=3, theta_ls=2.0)
    assert binary_threshold_ess.launches == before + (C == 2)
    assert not bool((state.theta_idx == state.theta_idx[:, :1]).all())


@pytest.mark.gpu
def test_gpirt_mcmc_runs_on_the_card_by_default(cuda_device):
    """No ``device`` argument: the run is on the card (one kernel launch a
    sweep of binary data)."""
    rng = np.random.default_rng(0)
    votes = np.where(rng.random((20, 12)) < 0.5, 1.0, 6.0)
    before = binary_threshold_ess.launches
    out = gpirt_mcmc(votes, sample_iterations=3, burn_iterations=2, CHAIN=2)
    assert binary_threshold_ess.launches == before + 5
    assert all(np.isfinite(d["ll"]).all() for d in out)


@pytest.mark.gpu
@pytest.mark.parametrize("fstar_method", ["matheron", "chol"])
@pytest.mark.parametrize("C", [2, 5])
def test_two_stage_sweep_on_card_matches_cpu(cuda_device, C, fstar_method):
    """An untempered two-stage sweep (chip_smoke.py's phase 12 inputs): theta
    identical, draw_f's f, beta and the cutpoints within 1e-3, f and f*
    within 1e-3 + 1e-3 |x| plus four times the lane's own rounding spread
    on the CPU (Matheron's smoother and the posterior Cholesky amplify
    float32 rounding); at C = 2 the kernel runs once."""
    cfg, priors, state0, draws, y = chip_smoke.sweep_inputs(
        C, model_y=True, f_method="two_stage", fstar_method=fstar_method)
    cpu = torch.device("cpu")
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, cuda_device)}
    before = binary_threshold_ess.launches
    s_cpu, ll_cpu, f_cpu = chip_smoke.two_stage_sweep_on(cpu, state0, draws, y,
                                                         consts[cpu], cfg)
    s_gpu, ll_gpu, f_gpu = chip_smoke.two_stage_sweep_on(cuda_device, state0, draws, y,
                                                         consts[cuda_device], cfg)
    assert binary_threshold_ess.launches == before + (C == 2)
    assert torch.equal(s_cpu.theta_idx, s_gpu.theta_idx.cpu())
    for got, want in ((f_gpu, f_cpu), (s_gpu.beta, s_cpu.beta),
                      (s_gpu.thresholds, s_cpu.thresholds)):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
    spread = chip_smoke.sweep_spread(state0, draws, y, consts[cpu], cfg)
    for k in ("f", "fstar"):
        ratio, _ = chip_smoke.held_to_spread(getattr(s_gpu, k), getattr(s_cpu, k), spread[k])
        assert ratio <= 1.0, (k, ratio)
    assert bool(torch.isfinite(ll_gpu).all())


@pytest.mark.gpu
def test_recover_fstar_runs_on_the_card_by_default(cuda_device):
    """recover_fstar and recover_fstar_batch with no ``device`` argument:
    finite f* of the reference shapes, the same under one seed."""
    from gpirt_tpu_torch import recover_fstar, recover_fstar_batch

    rng = np.random.default_rng(1)
    votes = np.where(rng.random((20, 12)) < 0.5, 1.0, 6.0)
    d = gpirt_mcmc(votes, sample_iterations=3, burn_iterations=1, CHAIN=1,
                   f_method="two_stage", store_f=True,
                   theta_init=np.linspace(-2, 2, 20))[0]
    rm = np.where(votes == 1.0, 1.0, 0.0)
    args = (d["f"][-1], rm, d["theta"][-1], d["beta"][-1], d["threshold"][-1])
    rec = recover_fstar(5, *args)
    assert rec["fstar"].shape == (1001, 12, 1) and np.isfinite(rec["fstar"]).all()
    np.testing.assert_array_equal(rec["fstar"], recover_fstar(5, *args)["fstar"])
    batch = recover_fstar_batch(5, d, rm)
    assert batch.shape == (3, 1001, 12, 1) and np.isfinite(batch).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [20, 100, 200, 1000, 2100])
def test_kernel_one_c_a_chain(cuda_device, n):
    """Chip_smoke's phase 17 at small sizes, on every path the kernel
    chooses from n: each chain at its own temperature (a ladder from 1 to
    64) against the plain version; a vector of one value gives bit for bit
    what that float gives."""
    K = 16
    args = _lane_inputs(cuda_device, K=K, n=n, m=97, seed=n)
    c = chip_smoke.c_of(chip_smoke.ladder(K, dev=cuda_device))
    got = binary_threshold_ess(*args, c)
    _assert_matches_plain(got, binary_threshold_ess_reference(*args, c))
    for k in (0, K - 1):  # each chain as it is at its scalar c
        one = [args[0][k:k + 1], args[1]] + [a[k:k + 1] for a in args[2:6]] + [
            args[6][:, k:k + 1].contiguous()]
        torch.testing.assert_close(binary_threshold_ess(*one, float(c[k])), got[k:k + 1],
                                   rtol=0, atol=0)
    same = torch.full((K,), _C, device=cuda_device)
    assert torch.equal(binary_threshold_ess(*args, same), binary_threshold_ess(*args, _C))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [2, 5])
def test_tempered_sweep_on_card_matches_cpu(cuda_device, C):
    """Chip_smoke's phase 18: one sweep with one temperature a chain; at
    C = 2 the kernel runs once, with one c a chain."""
    before = binary_threshold_ess.launches
    _sweep_on_both(cuda_device, C=C, temp=torch.tensor(chip_smoke.SWEEP_TEMPS))
    assert binary_threshold_ess.launches == before + (C == 2)


@pytest.mark.gpu
def test_tempered_gpirt_mcmc_on_the_card(cuda_device):
    """Chip_smoke's phase 19 at a small size: one launch a sweep, each with
    as many distinct c values as rungs."""
    rng = np.random.default_rng(2)
    votes = np.where(rng.random((20, 12)) < 0.5, 1.0, 6.0)
    scales = []
    binary_threshold_ess.launches = 0
    out, _ = chip_smoke.observe_kernel(lambda: gpirt_mcmc(
        votes, 4, 2, CHAIN=2, n_temps=3, max_temp=4.0, verbose=False), scales=scales)
    assert binary_threshold_ess.launches == len(scales) == 6
    assert all(int(torch.unique(c).numel()) == 3 for c in scales)
    assert out[0]["swap_rate"].shape == (2,)
    assert all(np.isfinite(d["ll"]).all() for d in out)


@pytest.mark.gpu
def test_gpirt_campaigns_on_the_card(cuda_device):
    """Chip_smoke's phase 20 at a small size: no device argument, Newton
    cutpoints (no launch), finite estimates."""
    from gpirt_tpu_torch import gpirt_campaigns

    rng = np.random.default_rng(3)
    votes = np.where(rng.random((20, 12)) < 0.5, 1.0, 6.0)
    before = binary_threshold_ess.launches
    out = gpirt_campaigns(votes, n_campaigns=3, n_chains=4, sample_iterations=6,
                          burn_iterations=2, smc_steps=6, verbose=False)
    assert binary_threshold_ess.launches == before
    assert out["theta_mean"].shape == (20, 1) and np.isfinite(out["theta_mean"]).all()
    assert np.isfinite(out["theta_se"]).all()


@pytest.mark.gpu
def test_kernel_pooled_layout(cuda_device):
    """The constant_IRF cutpoint update's layout at the shared-IRF path's
    width: g (64, 10, 150, 60) viewed as (64, 1, 1500, 60), y as
    (1, 1500, 60), one t_1 a (chain, item) (the 256-thread register path),
    against its plain version on the same views."""
    rng = np.random.default_rng(3)
    K, H, n, m = 64, 10, 150, 60
    g = torch.as_tensor(1.5 * rng.standard_normal((K, H, n, m)), dtype=torch.float32,
                        device=cuda_device)
    y = torch.as_tensor(rng.choice([0, 1, 2], size=(H, n, m), p=[0.1, 0.45, 0.45]),
                        dtype=torch.int32, device=cuda_device)
    lanes = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (
        rng.standard_normal((K, 1, m)), rng.standard_normal((K, 1, m)),
        np.log(rng.random((K, 1, m))), rng.random((K, 1, m)) * _TWO_PI,
        rng.random((64, K, 1, m)))]
    args = (g.view(K, 1, H * n, m), y.view(1, H * n, m), *lanes)
    before = binary_threshold_ess.launches
    got = binary_threshold_ess(*args, _C)
    torch.cuda.synchronize()
    assert binary_threshold_ess.launches == before + 1
    _assert_matches_plain(got, binary_threshold_ess_reference(*args, _C))
    assert float((got != args[2]).float().mean()) > 0.8


@pytest.mark.gpu
@pytest.mark.parametrize("constant_IRF", [True, False])
def test_grid_sweep_on_card_matches_cpu(cuda_device, constant_IRF):
    """A grid sweep over three sessions (chip_smoke.py's phase 23), one IRF
    shared by the sessions or one a session: theta equal, every field
    within 1e-3, one kernel launch; shared f* and cutpoints on the card."""
    chip_smoke.shared_irf_check(cuda_device, "grid", constant_IRF)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["ESS theta, CST", "ESS theta, RDM", "ESS theta, GP",
                                   "affine, T=1", "affine, per-chain T"])
def test_option_sweep_on_card_matches_cpu(cuda_device, label):
    """chip_smoke's phase 26 check of the ESS theta update and of the affine
    moves (untempered and on a ladder): theta equal, or a float32 tie by
    PERF.md's rule, every other field within 1e-3."""
    (inputs, temp, it), = [(i, t, k) for name, i, t, k in chip_smoke.OPTION_CHECKS
                           if name == label]
    chip_smoke.option_check(cuda_device, label, inputs, temp, it)
