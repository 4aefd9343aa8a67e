"""Port tests that need the card: the CUDA kernel against its plain version,
over shapes (every thread-group size the kernel chooses from n) and edge
cases, and one whole sweep on the card against the same sweep on the CPU.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
This file imports no JAX, so on a machine with an NVIDIA GPU and nvcc but
no JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from gpirt_tpu_torch.models import gibbs
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
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


@pytest.mark.gpu
def test_sweep_on_card_matches_cpu(cuda_device):
    """One float32 sweep from the same state and draws on both devices:
    theta identical, the rest within 1e-3 (float32 products and solves in
    another order)."""
    K, n, m, N = 3, 12, 9, 101
    rng = np.random.default_rng(1)
    y = np.where(rng.random((1, n, m)) < 0.5, 2, 1).astype(np.int32)
    y[0, 0, :3] = 0
    cfg = GPIRTConfig(n=n, m=m, grid_size=N, dtype="float32", jitter=1e-5)
    priors = (np.zeros((3, m)), np.full((3, m), 3.0), np.zeros((2, n)),
              np.zeros((2, n)))
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    consts = {d: make_constants(cfg, *priors, device=d) for d in (cpu, cuda_device)}
    state0 = gibbs.init_state(
        torch.as_tensor(rng.uniform(-1, 1, (K, 1, n))),
        torch.as_tensor(np.tile([-np.inf, 0.0, np.inf], (1, m, 1))),
        consts[cpu], cfg, gibbs.init_draws(gen, K, consts[cpu], cfg))
    draws = gibbs.sweep_draws(gen, K, consts[cpu], cfg)
    out = {}
    for d in (cpu, cuda_device):
        out[d] = gibbs.gibbs_sweep(
            gibbs.GPIRTState(*(a.to(d) for a in state0)),
            gibbs.SweepDraws(*(a.to(d) for a in draws)),
            torch.as_tensor(y, device=d), consts[d], cfg, temp=4.0)
    (s_cpu, ll_cpu), (s_gpu, ll_gpu) = out[cpu], out[cuda_device]
    assert torch.equal(s_cpu.theta_idx, s_gpu.theta_idx.cpu())
    for a, b in zip(s_cpu[1:], s_gpu[1:]):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(ll_gpu.cpu(), ll_cpu, rtol=1e-4, atol=1e-3)
