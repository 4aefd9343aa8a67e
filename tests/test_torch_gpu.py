"""Port tests that need the card: the CUDA kernel against its plain version,
over shapes (every path and thread-group size the kernel chooses from n),
edge cases and one c a chain; whole sweeps on the card against the same sweeps on the
CPU (binary, ordinal with the cutpoints by ESS and by Newton, over three
sessions in the GP theta regime, with one temperature a chain, the
two-stage sampler with f* by both methods, and the grid sampler with one
IRF shared by the sessions and without, the ESS theta update in the three
regimes, the affine moves untempered and with one temperature a chain);
the kernel at the pooled constant_IRF layout (on its register and tile
paths) and the path it takes by n; gpirt_mcmc (tempered too),
gpirt_campaigns, recover_fstar and recover_fstar_batch on the card by
default; checkpointed gpirt_mcmc calls interrupted and resumed bit for bit
(SMC-initialised and tempered), and refused on the CPU; profile_sweep
timing with CUDA events; the sweep's spans on the stream and on the
profiler's clock; the walkthrough example on the card; and one
sweep with the items, and one with the respondents, over 2 ranks sharing
the card against the unsharded sweep; one sweep of 512 lanes against
batches of 64 lanes, bit for bit, and each sweep family's at 128 and 512
lanes against batches of 64, 32 and 16; the ordinal cutpoint kernel
against its plain version at the SDO benchmark's shapes, at C = 3 and 7,
with missing sites, lanes at the round cap, one c a chain, over sessions and
on every path it chooses from n, each lane's bits against its batch, and its
one launch a sweep.

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
from gpirt_tpu_torch.ops.ess import ess_update
from gpirt_tpu_torch.ops.threshold_ess import (
    binary_threshold_ess,
    binary_threshold_ess_reference,
    launch_plan,
    ordinal_launch_plan,
    ordinal_threshold_ess,
    ordinal_threshold_ess_reference,
)

_C = 0.7071067811865476
_TWO_PI = 6.283185307179586


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc)")
    return torch.device("cuda")


# n relative to the kernel's tile capacity (launch_plan), read on the card
# inside a test: the largest n of the tile path, one more (the streaming
# path), and twice it
_PAST_CAP = {"capacity": 0, "capacity+1": 1, "2 x capacity": None}


def _resolve_n(n):
    """An n of a parametrisation: an int as it is, or a key of _PAST_CAP."""
    if isinstance(n, int):
        return n
    cap = launch_plan(2049)["tile_capacity"]
    return 2 * cap if _PAST_CAP[n] is None else cap + _PAST_CAP[n]


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
@pytest.mark.parametrize("m", [97, 418, 1000])
@pytest.mark.parametrize("n", [1, 31, 33, 100, 200, 257, 2049, 4099, 5000, "capacity",
                               "capacity+1", "2 x capacity"])
def test_kernel_over_shapes(cuda_device, n, m, H, temp):
    """Every path the kernel chooses from n (8 threads a lane up to n = 32,
    a warp up to 256, a block of registers up to 2048, the tile path up to
    its capacity, streaming beyond), unaligned m, several sessions, and items
    with no observed response."""
    n = _resolve_n(n)
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
@pytest.mark.parametrize("n", [100, 5000, "capacity+1"])
def test_kernel_round_cap_keeps_t0(cuda_device, R, temp, n):
    """With a cap of R rounds, a lane not accepted by then keeps t0 bit for
    bit, as in the plain version: on the register, tile and streaming
    paths."""
    n = _resolve_n(n)
    args = _lane_inputs(cuda_device, K=16, n=n, m=418, R=R, seed=R)
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
    """A C = 5 sweep at T = 1 and 64, its cutpoints by the ordinal ESS (the
    ordinal kernel, once) or by Newton-proposal MH; the binary kernel is
    not launched."""
    before, ordinal = binary_threshold_ess.launches, ordinal_threshold_ess.launches
    state0, state = _sweep_on_both(cuda_device, C=5, method=method, temp=temp)
    assert binary_threshold_ess.launches == before
    assert ordinal_threshold_ess.launches == ordinal + (method == "ess")
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
@pytest.mark.parametrize("n", [20, 100, 200, 1000, 2100, 5000, "capacity+1"])
def test_kernel_one_c_a_chain(cuda_device, n):
    """Chip_smoke's phase 17 at small sizes, on every path the kernel
    chooses from n: each chain at its own temperature (a ladder from 1 to
    64) against the plain version; a vector of one value gives bit for bit
    what that float gives."""
    K = 16
    n = _resolve_n(n)
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
def test_kernel_pooled_layout_tile_path(cuda_device):
    """The pooled constant_IRF layout where its H n stacked sites take the
    tile path: g (16, 10, 300, 60) viewed as (16, 1, 3000, 60), y as
    (1, 3000, 60), items with no response in any session, against the plain
    version on the same views."""
    rng = np.random.default_rng(4)
    K, H, n, m = 16, 10, 300, 60
    g = torch.as_tensor(1.5 * rng.standard_normal((K, H, n, m)), dtype=torch.float32,
                        device=cuda_device)
    y = torch.as_tensor(rng.choice([0, 1, 2], size=(H, n, m), p=[0.1, 0.45, 0.45]),
                        dtype=torch.int32, device=cuda_device)
    y[:, :, 0] = 0
    lanes = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (
        rng.standard_normal((K, 1, m)), rng.standard_normal((K, 1, m)),
        np.log(rng.random((K, 1, m))), rng.random((K, 1, m)) * _TWO_PI,
        rng.random((64, K, 1, m)))]
    args = (g.view(K, 1, H * n, m), y.view(1, H * n, m), *lanes)
    assert launch_plan(H * n)["path"] == "tile"
    before = binary_threshold_ess.launches
    got = binary_threshold_ess(*args, _C)
    torch.cuda.synchronize()
    assert binary_threshold_ess.launches == before + 1
    err = _assert_matches_plain(got, binary_threshold_ess_reference(*args, _C))
    assert float(err[:, :, 0].max()) <= 1e-5
    assert float((got != args[2]).float().mean()) > 0.8


@pytest.mark.gpu
def test_launch_plan_by_n(cuda_device):
    """The path the kernel takes by n: registers up to 2048, the tile path up
    to its capacity (its shared memory within a Hopper block's opt-in limit
    of 232,448 bytes), the streaming path beyond."""
    limit = 232448
    cap = launch_plan(2049)["tile_capacity"]
    assert cap >= 5000
    for n in (1, 100, 2048):
        assert launch_plan(n)["path"] == "registers"
    for n in (2049, 5000, cap):
        plan = launch_plan(n)
        assert plan["path"] == "tile" and plan["smem_bytes"] <= limit
    assert launch_plan(cap + 1)["path"] == "streaming"


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


def _votes(seed=3, n=20, m=12):
    rng = np.random.default_rng(seed)
    p = 1 / (1 + np.exp(-np.outer(np.linspace(-2, 2, n), rng.standard_normal(m) * 2)))
    return np.where(rng.random((n, m)) < p, 1.0, 6.0)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [dict(smc_steps=4, smc_max_temp=8.0),
                                     dict(n_temps=3, max_temp=4.0)])
def test_gpirt_mcmc_resumes_bitwise_on_the_card(cuda_device, tmp_path, variant):
    """An interrupted and resumed checkpointed call on the card returns the
    plain call's chain dicts bit for bit, one kernel launch a sweep over
    the pair; the checkpoint does not resume on the CPU (the generator's
    state belongs to its device type)."""
    votes = _votes()
    kw = dict(CHAIN=4, SEED=3, verbose=False, **variant)
    want = gpirt_mcmc(votes, 6, 4, **kw)
    ck = dict(kw, checkpoint_path=str(tmp_path / "run"), checkpoint_every=3)
    before = binary_threshold_ess.launches
    gpirt_mcmc(votes, 2, 4, **ck)
    got = gpirt_mcmc(votes, 6, 4, **ck)
    if "n_temps" in variant:  # the SMC steps launch the kernel too
        assert binary_threshold_ess.launches - before == 10
    for d_got, d_want in zip(got, want):
        for k in d_want:
            if k != "seconds":
                np.testing.assert_array_equal(d_got[k], d_want[k], err_msg=k)
    with pytest.raises(ValueError, match="rng_device: checkpoint='cuda' vs requested='cpu'"):
        gpirt_mcmc(votes, 6, 4, **dict(ck, device="cpu"))


@pytest.mark.gpu
def test_profile_sweep_times_with_cuda_events(cuda_device, monkeypatch):
    from gpirt_tpu_torch.models.config import GPIRTConfig
    from gpirt_tpu_torch.utils.profiling import profile_sweep

    made = []
    event = torch.cuda.Event

    def counted(*args, **kwargs):
        made.append(1)
        return event(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "Event", counted)
    y = torch.as_tensor(np.where(_votes() == 1.0, 2, 1).astype(np.int32)[None],
                        device=cuda_device)
    cfg = GPIRTConfig(n=20, m=12, dtype="float32", jitter=1e-5)
    consts = make_constants(cfg, np.zeros((3, 12)), np.full((3, 12), 3.0),
                            np.zeros((2, 20)), np.zeros((2, 20)), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ti = torch.zeros((4, 1, 20), device=cuda_device)
    thr = torch.as_tensor(np.tile([-np.inf, 0.0, np.inf], (1, 12, 1)), dtype=torch.float32,
                          device=cuda_device)
    state = gibbs.init_state(ti, thr, consts, cfg, gibbs.init_draws(gen, 4, consts, cfg))
    out = profile_sweep(state, gibbs.sweep_draws(gen, 4, consts, cfg), y, consts, cfg,
                        reps=3)
    assert len(out) == 6 and all(np.isfinite(v) and v > 0 for v in out.values()), out
    assert len(made) == 6 * 2 * 2 * 2  # six blocks, two counts, two runs, two events


@pytest.mark.gpu
def test_sweep_spans_on_the_card(cuda_device):
    """Three sweeps under a CUDA profiler: every block span of the conjugate
    sweep has a positive stream time, a root's children take no more of the
    stream than the root, and the host launch of each cutpoint kernel, found
    by its correlation id, lies inside a ``sweep.cutpoints`` span."""
    from gpirt_tpu_torch.models.config import GPIRTConfig
    from gpirt_tpu_torch.models.sampler import Carry, advance_chains, sample_schedule
    from gpirt_tpu_torch.utils.profiling import clear_spans, span_totals, spans

    y = torch.as_tensor(np.where(_votes() == 1.0, 2, 1).astype(np.int32)[None],
                        device=cuda_device)
    cfg = GPIRTConfig(n=20, m=12, dtype="float32", jitter=1e-5)
    consts = make_constants(cfg, np.zeros((3, 12)), np.full((3, 12), 3.0),
                            np.zeros((2, 20)), np.zeros((2, 20)), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ti = torch.zeros((4, 1, 20), device=cuda_device)
    thr = torch.as_tensor(np.tile([-np.inf, 0.0, np.inf], (1, 12, 1)), dtype=torch.float32,
                          device=cuda_device)
    carry = Carry(gibbs.init_state(ti, thr, consts, cfg, gibbs.init_draws(gen, 4, consts, cfg)))
    sched = sample_schedule(10, 0, 1)
    advance_chains(gen, carry, y, consts, cfg, sched, 0, 1)  # warm
    clear_spans()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            advance_chains(gen, carry, y, consts, cfg, sched, 1, 4)
            torch.cuda.synchronize(cuda_device)
        tot, recs = span_totals(), spans()
    finally:
        clear_spans()
    blocks = ("sweep.draws", "sweep.theta", "sweep.z", "sweep.fstar", "sweep.beta",
              "sweep.cutpoints", "sweep.ll")
    assert tot["sweep"].count == 3
    assert all(tot[b].stream_ms > 0 for b in blocks), tot
    for root in (s for s in recs if s.name == "sweep"):
        kids = sum(s.stream_ms for s in recs if s.parent == root.id)
        assert 0 < kids <= root.stream_ms + 1e-3, (kids, root.stream_ms)
    events = prof.profiler.kineto_results.events()
    kernels = {ev.correlation_id() for ev in events
               if ev.device_type() == torch.autograd.DeviceType.CUDA
               and any(k in ev.name() for k in ("ess_regs", "ess_tile", "ess_stream"))}
    launches = [ev.start_ns() for ev in events
                if ev.device_type() == torch.autograd.DeviceType.CPU
                and "LaunchKernel" in ev.name() and ev.correlation_id() in kernels]
    cuts = [(s.start_ns, s.end_ns) for s in recs if s.name == "sweep.cutpoints"]
    assert len(launches) == 3
    assert all(any(a <= t <= b for a, b in cuts) for t in launches), (launches, cuts)


@pytest.mark.gpu
def test_walkthrough_example_on_the_card(cuda_device):
    """examples/torch_senate116_walkthrough.py's main() on the card at a
    small size: one kernel launch a sweep, finite posterior means."""
    walk = chip_smoke.load_example("torch_senate116_walkthrough")
    before = binary_threshold_ess.launches
    out = walk.main(["--iters", "30", "--burn", "10", "--chains", "2"])
    assert binary_threshold_ess.launches == before + 40
    assert out["chain_means"].shape == (2, 100) and np.isfinite(out["theta_hat"]).all()


@pytest.mark.gpu
def test_item_sharded_sweep_on_card_matches_unsharded(cuda_device, tmp_path):
    """One sweep with the items over 2 ranks that share the card (Gloo,
    parallel/distributed.launch) against the unsharded sweep on the card,
    from the same state, constants and draws (the shards' cut to their
    items): theta equal, every other field within 1e-3, theta the same on
    both ranks."""
    import _torch_dist_worker as w
    from gpirt_tpu_torch.parallel.distributed import launch

    cfg = w.card_config()
    consts = make_constants(cfg, np.zeros((3, w.m)), np.full((3, w.m), 3.0),
                            np.zeros((2, w.n)), np.zeros((2, w.n)), device=cuda_device)
    y = torch.as_tensor(np.nan_to_num(w.votes(), nan=0.0)[None].astype(np.int32),
                        device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = gibbs.init_state(torch.linspace(-1, 1, w.n, device=cuda_device).expand(w.K, 1, w.n),
                             torch.as_tensor(chip_smoke.default_thresholds(2, w.m, 1),
                                             device=cuda_device),
                             consts, cfg, gibbs.init_draws(gen, w.K, consts, cfg))
    draws = gibbs.sweep_draws(torch.Generator(device=cuda_device).manual_seed(3), w.K,
                              consts, cfg)
    want, want_ll = gibbs.gibbs_sweep(state, draws, y, consts, cfg)
    path = str(tmp_path / "inputs.pt")
    torch.save({"state": [a.cpu() for a in state], "y": y.cpu(),
                "consts": {k: None if v is None else v.cpu() for k, v in vars(consts).items()}},
               path)
    assert launch(w.card_sharded_sweep, 2, (path, str(tmp_path)), device="cuda",
                  timeout=300) == [0, 1]
    blocks = [torch.load(tmp_path / f"card_rank{r}.pt") for r in range(2)]
    assert torch.equal(blocks[0][0], blocks[1][0])
    torch.testing.assert_close(blocks[0][0], want.theta_idx.cpu(), rtol=0, atol=0)
    for i, (name, dim) in enumerate((("f", -1), ("beta", -1), ("thresholds", -2),
                                     ("fstar", -1)), start=1):
        got = torch.cat([b[i] for b in blocks], dim=dim)
        torch.testing.assert_close(got, getattr(want, name).cpu(), rtol=0, atol=1e-3)
    torch.testing.assert_close(blocks[0][5], want_ll.cpu(), rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_respondent_sharded_sweep_on_card_matches_unsharded(cuda_device, tmp_path):
    """One sweep with the respondents over 2 ranks that share the card
    (Gloo, parallel/distributed.launch) against the unsharded sweep on the
    card, from the same state, constants and draws (the shards' cut to
    their respondents): beta, the cutpoints, f* and the ll bit for bit the
    same on both ranks, theta equal, beta and the cutpoints within 1e-3, f
    and f* within 1e-3 + 1e-3 |x| (f* is drawn from sums over the
    respondents, which the shards add in another order)."""
    import _torch_dist_worker as w
    from gpirt_tpu_torch.parallel.distributed import launch

    cfg = w.card_config()
    consts = make_constants(cfg, np.zeros((3, w.m)), np.full((3, w.m), 3.0),
                            np.zeros((2, w.n)), np.zeros((2, w.n)), device=cuda_device)
    y = torch.as_tensor(np.nan_to_num(w.votes(), nan=0.0)[None].astype(np.int32),
                        device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = gibbs.init_state(torch.linspace(-1, 1, w.n, device=cuda_device).expand(w.K, 1, w.n),
                             torch.as_tensor(chip_smoke.default_thresholds(2, w.m, 1),
                                             device=cuda_device),
                             consts, cfg, gibbs.init_draws(gen, w.K, consts, cfg))
    draws = gibbs.sweep_draws(torch.Generator(device=cuda_device).manual_seed(3), w.K,
                              consts, cfg)
    want, want_ll = gibbs.gibbs_sweep(state, draws, y, consts, cfg)
    path = str(tmp_path / "inputs.pt")
    torch.save({"state": [a.cpu() for a in state], "y": y.cpu(),
                "consts": {k: None if v is None else v.cpu() for k, v in vars(consts).items()}},
               path)
    assert launch(w.card_respondent_sweep, 2, (path, str(tmp_path)), device="cuda",
                  timeout=300) == [0, 1]
    blocks = [torch.load(tmp_path / f"card_resp_rank{r}.pt") for r in range(2)]
    for i in (2, 3, 4, 5):
        assert torch.equal(blocks[0][i], blocks[1][i])
    torch.testing.assert_close(torch.cat([b[0] for b in blocks], dim=-1),
                               want.theta_idx.cpu(), rtol=0, atol=0)
    for name in ("beta", "thresholds"):
        torch.testing.assert_close(blocks[0][2 if name == "beta" else 3],
                                   getattr(want, name).cpu(), rtol=0, atol=1e-3)
    torch.testing.assert_close(torch.cat([b[1] for b in blocks], dim=-2), want.f.cpu(),
                               rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(blocks[0][4], want.fstar.cpu(), rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(blocks[0][5], want_ll.cpu(), rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("label", ["theta_ess", "affine"])
def test_item_sharded_option_sweep_on_card_matches_unsharded(cuda_device, tmp_path, label):
    """One sweep with ESS theta, or with the affine moves (W 3, 2 rounds),
    with the items over 2 ranks that share the card (Gloo) against the
    unsharded sweep on the card, from the same state, constants and draws
    (the shards' cut to their items; theta's and the affine moves' numbers
    whole): theta equal and the same on both ranks, every other field
    within 1e-3."""
    import _torch_mesh_worker as mw
    from gpirt_tpu_torch.parallel.distributed import launch

    w = mw.w
    cfg = mw.card_option_config(label)
    consts = make_constants(cfg, np.zeros((3, w.m)), np.full((3, w.m), 3.0),
                            np.zeros((2, w.n)), np.zeros((2, w.n)), device=cuda_device)
    y = torch.as_tensor(np.nan_to_num(w.votes(), nan=0.0)[None].astype(np.int32),
                        device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = gibbs.init_state(torch.linspace(-1, 1, w.n, device=cuda_device).expand(w.K, 1, w.n),
                             torch.as_tensor(chip_smoke.default_thresholds(2, w.m, 1),
                                             device=cuda_device),
                             consts, cfg, gibbs.init_draws(gen, w.K, consts, cfg))
    draws = gibbs.sweep_draws(torch.Generator(device=cuda_device).manual_seed(3), w.K,
                              consts, cfg)
    want, want_ll = gibbs.gibbs_sweep(state, draws, y, consts, cfg)
    path = str(tmp_path / "inputs.pt")
    torch.save({"state": [a.cpu() for a in state], "y": y.cpu(),
                "consts": {k: None if v is None else v.cpu() for k, v in vars(consts).items()}},
               path)
    assert launch(mw.card_option_sweep, 2, (path, str(tmp_path), label), device="cuda",
                  timeout=300) == [0, 1]
    blocks = [torch.load(tmp_path / f"card_{label}_rank{r}.pt") for r in range(2)]
    assert torch.equal(blocks[0][0], blocks[1][0])
    torch.testing.assert_close(blocks[0][0], want.theta_idx.cpu(), rtol=0, atol=0)
    for i, (name, dim) in enumerate((("f", -1), ("beta", -1), ("thresholds", -2),
                                     ("fstar", -1)), start=1):
        got = torch.cat([b[i] for b in blocks], dim=dim)
        torch.testing.assert_close(got, getattr(want, name).cpu(), rtol=0, atol=1e-3)
    torch.testing.assert_close(blocks[0][5], want_ll.cpu(), rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_sweep_lanes_on_card_do_not_depend_on_the_batch(cuda_device):
    """One sweep of campaigns8's 512 lanes on the card against the same
    lanes in batches of 64, block by block and whole, plain, tempered and
    with the kernel's cutpoint update (chip_smoke phase 51): every block
    bit for bit (cuBLAS picks a batched kernel by the batch count, so the
    sweep runs its one batch-dependent product 64 lanes at a time)."""
    from gpirt_tpu_torch import campaigns
    from gpirt_tpu_torch.utils.datasets import senate116_response_matrix

    rm, _, _ = senate116_response_matrix()
    prob = campaigns._problem(np.asarray(rm), chip_smoke.CAMPAIGNS,
                              SEED=chip_smoke.CAMPAIGN_SEED, vote_codes=None,
                              device=cuda_device)
    res = chip_smoke.sweep_block_check(prob, 512, 64)
    assert len(res) == 4
    for label, apart in res.items():
        assert not any(apart.values()), (label, apart)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [128, 512])
@pytest.mark.parametrize("family", chip_smoke.FAMILIES)
def test_family_lanes_on_card_do_not_depend_on_the_batch(cuda_device, family, lanes):
    """Each sweep family at its chip_smoke cell (chip_smoke phase 51's
    check, FAMILY_CASES): one sweep of ``lanes`` chains against the same
    lanes in batches of 64, 32 and 16, every block the sweep runs and the
    whole sweep bit for bit (the calls that would round a lane by its batch
    on the card run 64 lanes at a time, ``ops.linalg.lane_chunked``)."""
    from gpirt_tpu_torch.utils.datasets import senate116_response_matrix

    rm, _, _ = senate116_response_matrix()
    res = chip_smoke.family_block_check(family, rm, cuda_device, lanes)
    assert len(res) == len(chip_smoke.FAMILY_CASES[family]) * len(chip_smoke.FAMILY_CHUNKS)
    for label, apart in res.items():
        assert not any(apart.values()), (label, {k: v for k, v in apart.items() if v})


def _ordinal_inputs(device, K=4, H=1, n=50, m=16, C=5, R=64, missing=0.05, seed=0):
    """g (K, H, n, m), y (H, n, m) categories 1..C with a share ``missing``
    of 0, the deltas of cutpoints near the data's (K, H, m, C-1), nu, logu,
    eps0 and rs, float32 (y int32) on ``device``."""
    rng = np.random.default_rng(seed)
    g = 0.8 * rng.standard_normal((K, H, n, m))
    y = rng.integers(1, C + 1, (H, n, m))
    y[rng.random((H, n, m)) < missing] = 0
    d = np.concatenate([-1.0 + 0.3 * rng.standard_normal((K, H, m, 1)),
                        -0.5 + 0.3 * rng.standard_normal((K, H, m, C - 2))], axis=-1)
    nu = rng.standard_normal((K, H, m, C - 1))
    logu = np.log(rng.random((K, H, m)))
    eps0 = rng.random((K, H, m)) * _TWO_PI
    rs = rng.random((R, K, H, m))
    f32 = [torch.as_tensor(a, dtype=torch.float32, device=device)
           for a in (g, d, nu, logu, eps0, rs)]
    return [f32[0], torch.as_tensor(y, dtype=torch.int32, device=device)] + f32[1:]


def _ladder(K, device):
    """c of a tempering ladder, one temperature a chain from 1 to 64."""
    return (_C / torch.sqrt(torch.logspace(0, 6, K, base=2.0))).to(torch.float32).to(device)


def _assert_ordinal_matches_plain(got, want, d):
    """The ordinal kernel's rule on the card: every lane within 1e-5 of the
    plain version (both float32 on the card), except at most 0.1% of lanes,
    or 2, whose accept flipped on a near-tie: the kernel sums a lane's
    observed sites in its own order, and the plain version sums the C
    categories' one-hot products of every site in torch.sum's. Nothing else
    differs: a proposal and its cutpoints are the same float operations."""
    lanes = (got - want).abs().amax(dim=-1)
    over = int((lanes > 1e-5).sum())
    assert over <= max(2, 0.001 * lanes.numel()), (over, lanes.numel(), float(lanes.max()))
    assert bool(torch.isfinite(got).all())
    moved = float((got != d).any(dim=-1).float().mean())
    assert moved > 0.5, moved


# label: (inputs, c a chain, the path the kernel takes)
_ORDINAL_CASES = {
    "sdo-k64": (dict(K=64, n=1500, m=16, C=5), False, "registers"),
    "sdo-k512": (dict(K=512, n=1500, m=16, C=5), True, "registers"),
    "C=3": (dict(K=16, n=300, m=20, C=3), False, "registers"),
    "C=7": (dict(K=16, n=100, m=21, C=7), True, "registers"),
    "missing": (dict(K=16, n=700, m=13, C=5, missing=0.6), True, "registers"),
    "few sites": (dict(K=32, n=40, m=45, C=5), False, "registers"),
    "sessions": (dict(K=8, H=3, n=200, m=16, C=4), True, "registers"),
    "pooled H n": (dict(K=64, n=3 * 1500, m=16, C=5), False, "tile"),
    "streaming": (dict(K=8, n=6000, m=16, C=5), True, "streaming"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_ORDINAL_CASES))
def test_ordinal_kernel_matches_plain_version(cuda_device, case):
    """The SDO benchmark's shapes (64 and 512 chains, n = 1500, m = 16, C =
    5), C = 3 and 7, missing sites, few sites, one c a chain, three
    sessions, and every path the kernel chooses from n (the sites in
    registers, the pooled constant_IRF layout of 3 x 1500 stacked sites in
    shared memory, and streaming past it)."""
    kw, ladder, path = _ORDINAL_CASES[case]
    args = _ordinal_inputs(cuda_device, **kw)
    c = _ladder(kw["K"], cuda_device) if ladder else _C
    assert ordinal_launch_plan(kw["n"], kw["C"])["path"] == path
    before = ordinal_threshold_ess.launches
    got = ordinal_threshold_ess(*args, c)
    torch.cuda.synchronize()
    assert ordinal_threshold_ess.launches == before + 1
    want = ordinal_threshold_ess_reference(*args, c)
    _assert_ordinal_matches_plain(got, want, args[2])


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("n", [40, 1500, 6000])
def test_ordinal_kernel_round_cap_keeps_d(cuda_device, R, n):
    """R = 1 and 2 rounds, and a slice level no proposal can reach on every
    other lane: those lanes keep their deltas bit for bit, the others
    follow the plain version."""
    args = _ordinal_inputs(cuda_device, K=8, n=n, m=16, C=5, R=R)
    args[4][:, :, ::2] = 1e30
    got = ordinal_threshold_ess(*args, _C)
    assert torch.equal(got[:, :, ::2], args[2][:, :, ::2])
    want = ordinal_threshold_ess_reference(*args, _C)
    lanes = (got - want).abs().amax(dim=-1)
    assert int((lanes > 1e-5).sum()) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("n", [40, 300, 1500, 4500, 6000])
def test_ordinal_kernel_lanes_do_not_depend_on_the_batch(cuda_device, n):
    """Each lane of a 512-chain launch (one c a chain) bit for bit the same
    lane of eight 64-chain launches, on every path the kernel takes: a
    lane's sum follows n and its own sites alone."""
    g, y, d, nu, logu, eps0, rs = _ordinal_inputs(cuda_device, K=512, n=n, m=13, C=5)
    c = _ladder(512, cuda_device)
    whole = ordinal_threshold_ess(g, y, d, nu, logu, eps0, rs, c)
    for k in range(0, 512, 64):
        part = ordinal_threshold_ess(g[k:k + 64], y, d[k:k + 64], nu[k:k + 64],
                                     logu[k:k + 64], eps0[k:k + 64],
                                     rs[:, k:k + 64].contiguous(), c[k:k + 64])
        assert torch.equal(part, whole[k:k + 64]), k


@pytest.mark.gpu
def test_ordinal_kernel_rejects_what_it_cannot_take(cuda_device):
    args = _ordinal_inputs(cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ordinal_threshold_ess(*[a.double() if a.is_floating_point() else a for a in args], _C)
    with pytest.raises(ValueError, match="int32"):
        ordinal_threshold_ess(args[0], args[1].long(), *args[2:], _C)
    with pytest.raises(ValueError, match="contiguous"):
        ordinal_threshold_ess(args[0].mT.contiguous().mT, *args[1:], _C)
    with pytest.raises(ValueError, match="C >= 3"):
        ordinal_threshold_ess(args[0], args[1], args[2][..., :1], args[3][..., :1],
                              *args[4:], _C)


@pytest.mark.gpu
def test_ordinal_kernel_one_launch_a_sweep(cuda_device):
    """gpirt_mcmc on ordinal data on the card: the cutpoint update is one
    launch a sweep and syncs nothing (no host-looped ESS runs)."""
    rng = np.random.default_rng(0)
    data = rng.integers(1, 6, (60, 12)).astype(np.float64)
    before, syncs = ordinal_threshold_ess.launches, ess_update.syncs
    out = gpirt_mcmc(data, sample_iterations=4, burn_iterations=3, CHAIN=3, vote_codes=None,
                     dtype="float32", device=cuda_device)
    assert ordinal_threshold_ess.launches == before + 7
    assert ess_update.syncs == syncs
    assert all(np.isfinite(d["ll"]).all() for d in out)
