"""The port's checkpoint / resume (``gpirt_tpu_torch/utils/checkpoint.py``):
an uninterrupted checkpointed run equals ``run_chains`` /
``run_tempered_chains``, and an interrupted and resumed one equals the
uninterrupted one, with ``assert_array_equal`` on every draw and on
swap_rate; the run spec, a foreign or stale file, and a file without the
generator's state are refused; a failed write keeps the previous
checkpoint; and the JAX package's manager and the port's read each other's
state and draws.

Float64 on the CPU at n = 10, m = 5, a 101-point grid and K = 3 chains.
Two interrupts are made: a partial ``sample_iterations`` completed and
then extended, as JAX's test does, and an exception raised from
``on_progress`` after the second save, mid-burn.
"""

import dataclasses
import glob
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu.models.gibbs import GPIRTState as JState
from gpirt_tpu.utils.checkpoint import CheckpointManager as JManager
from gpirt_tpu_torch import api, gpirt_mcmc
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.models.sampler import run_chains
from gpirt_tpu_torch.parallel.tempering import run_tempered_chains
from gpirt_tpu_torch.utils.checkpoint import (
    CHECKPOINT_FORMAT_VERSION,
    CheckpointManager,
    run_chain_checkpointed,
    run_chains_checkpointed,
    run_tempered_chains_checkpointed,
)
from gpirt_tpu_torch.utils.datasets import simulate_2pl
from gpirt_tpu_torch.utils.response import encode_categories

K, BURN, SAMPLES = 3, 4, 6
TEMPERING = dict(n_temps=3, max_temp=8.0, swap_every=1)


class Interrupt(Exception):
    pass


def _setup(threshold_method="auto", n=10, m=5):
    _, raw = simulate_2pl(0, n=n, m=m, missing=0.1)
    y, C, _ = encode_categories(raw[:, :, None])
    cfg = GPIRTConfig(n=n, m=m, C=C, grid_size=101, dtype="float64",
                      threshold_method=threshold_method)
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0),
                            np.zeros((2, n)), np.zeros((2, n)), device="cpu")
    ti = torch.as_tensor(np.random.default_rng(1).uniform(-2, 2, (K, 1, n)))
    thr = torch.as_tensor(default_thresholds(C, m, 1))
    return torch.as_tensor(y), ti, thr, consts, cfg


def _gen(seed=4):
    return torch.Generator().manual_seed(seed)


def _assert_draws_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _interrupted(run, path, way):
    """Run ``run(manager, sample_iterations, on_progress)`` interrupted the
    given way, then resumed from a fresh generator; returns the resumed
    draws."""
    if way == "partial samples":
        run(CheckpointManager(path), 2, None)
    else:
        saves = []

        def interrupt(done, total):
            saves.append(done)
            if len(saves) == 2:
                raise Interrupt

        with pytest.raises(Interrupt):
            run(CheckpointManager(path), SAMPLES, interrupt)
        assert saves == [2, 4]  # mid-burn: BURN = 4 sweeps before the first draw
    assert os.path.exists(path)
    return run(CheckpointManager(path), SAMPLES, None)


@pytest.mark.parametrize("thin", [1, 2])
def test_checkpointed_run_equals_run_chains(tmp_path, thin):
    y, ti, thr, consts, cfg = _setup()
    kw = dict(sample_iterations=SAMPLES, burn_iterations=BURN, thin=thin,
              store_f=True, store_fstar=True)
    want = run_chains(_gen(), y, ti, thr, consts, cfg, **kw)
    got = run_chains_checkpointed(_gen(), y, ti, thr, consts, cfg,
                                  manager=CheckpointManager(str(tmp_path / "ck.npz")),
                                  checkpoint_every=3, **kw)
    _assert_draws_equal(got, want)
    one = run_chain_checkpointed(_gen(), y, ti[0], thr, consts, cfg,
                                 manager=CheckpointManager(str(tmp_path / "one.npz")),
                                 checkpoint_every=5, **kw)
    _assert_draws_equal(one, {k: v[0] for k, v in run_chains(
        _gen(), y, ti[:1], thr, consts, cfg, **kw).items()})


@pytest.mark.parametrize("threshold_method", ["auto", "interleave"])
@pytest.mark.parametrize("way", ["partial samples", "exception mid-burn"])
def test_interrupt_and_resume_equals_uninterrupted(tmp_path, way, threshold_method):
    """Under "interleave" the cutpoint update depends on the absolute
    iteration, which the resume must carry on from."""
    y, ti, thr, consts, cfg = _setup(threshold_method)
    kw = dict(burn_iterations=BURN, thin=1, store_f=True)
    want = run_chains(_gen(), y, ti, thr, consts, cfg, sample_iterations=SAMPLES, **kw)

    def run(manager, samples, on_progress):
        return run_chains_checkpointed(_gen(), y, ti, thr, consts, cfg, manager=manager,
                                       checkpoint_every=2, on_progress=on_progress,
                                       sample_iterations=samples, **kw)

    _assert_draws_equal(_interrupted(run, str(tmp_path / "ck.npz"), way), want)


@pytest.mark.parametrize("way", ["partial samples", "exception mid-burn"])
def test_tempered_interrupt_and_resume_equals_run_tempered_chains(tmp_path, way):
    y, ti, thr, consts, cfg = _setup()
    kw = dict(burn_iterations=BURN, thin=2, **TEMPERING)
    want = run_tempered_chains(_gen(), y, ti, thr, consts, cfg,
                               sample_iterations=SAMPLES, **kw)

    def run(manager, samples, on_progress):
        return run_tempered_chains_checkpointed(
            _gen(), y, ti, thr, consts, cfg, manager=manager, checkpoint_every=2,
            on_progress=on_progress, sample_iterations=samples, **kw)

    full = run(CheckpointManager(str(tmp_path / "full.npz")), SAMPLES, None)
    _assert_draws_equal(full, want)
    assert float(want["swap_rate"].sum()) > 0
    _assert_draws_equal(_interrupted(run, str(tmp_path / "ck.npz"), way), want)


_VARIANTS = {
    "plain": {},
    "SMC-initialised": dict(smc_steps=4, smc_max_temp=8.0),
    "interleaved cutpoints": dict(threshold_method="interleave", threshold_ess_every=3),
    "tempered": dict(TEMPERING),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_gpirt_mcmc_resumes_bitwise(tmp_path, monkeypatch, capsys, variant):
    """The checkpointed call, interrupted by a shorter call and resumed,
    returns the plain call's chain dicts; the resume does not anneal
    again; verbose prints JAX's progress lines."""
    _, raw = simulate_2pl(3, n=10, m=5)
    kw = dict(CHAIN=2, SEED=3, dtype="float64", grid_size=101, device="cpu",
              verbose=False, vote_codes={"yea": 1, "nay": 0, "missing": None},
              **_VARIANTS[variant])
    want = gpirt_mcmc(raw, SAMPLES, BURN, **kw)
    ck = dict(kw, checkpoint_path=str(tmp_path / "run"), checkpoint_every=3)
    gpirt_mcmc(raw, 2, BURN, **ck)
    assert os.path.exists(tmp_path / "run.npz")

    def no_anneal(*args, **kwargs):
        raise AssertionError("a resume ran the SMC initialization again")

    monkeypatch.setattr(api, "anneal_init", no_anneal)
    capsys.readouterr()
    got = gpirt_mcmc(raw, SAMPLES, BURN, **dict(ck, verbose=True))
    err = capsys.readouterr().err
    assert "=== MEMORY ESTIMATE ===" in err
    assert f"[gpirt] 9/{SAMPLES + BURN} iterations (90%)" in err
    assert f"[gpirt] {SAMPLES + BURN}/{SAMPLES + BURN} iterations (100%)" in err
    for d_got, d_want in zip(got, want):
        assert sorted(d_got) == sorted(d_want)
        for k in d_want:
            if k != "seconds":
                np.testing.assert_array_equal(d_got[k], d_want[k], err_msg=k)
        assert d_got["seconds"]["checkpoint"] > 0


@pytest.fixture
def partial(tmp_path):
    """A plain and a tempered checkpoint after 3 of 6 sweeps (one stored
    draw), and a resume call that takes overrides of their arguments."""
    y, ti, thr, consts, cfg = _setup()
    kw = dict(burn_iterations=2, thin=1)
    plain = CheckpointManager(str(tmp_path / "plain.npz"))
    tempered = CheckpointManager(str(tmp_path / "tempered.npz"))
    run_chains_checkpointed(_gen(), y, ti, thr, consts, cfg, manager=plain,
                            checkpoint_every=2, sample_iterations=1, **kw)
    run_tempered_chains_checkpointed(_gen(), y, ti, thr, consts, cfg, manager=tempered,
                                     checkpoint_every=2, sample_iterations=1, **kw,
                                     **TEMPERING)

    def resume(manager, **over):
        args = dict(gen=_gen(), y=y, theta_init=ti, thresholds_init=thr, consts=consts,
                    config=cfg, manager=manager, checkpoint_every=2,
                    sample_iterations=4, **kw)
        args.update(over)
        if manager is tempered:
            return run_tempered_chains_checkpointed(**dict(TEMPERING, **args))
        return run_chains_checkpointed(**args)

    return plain, tempered, resume


def _changed_config():
    cfg = _setup()[4]
    cfg2 = dataclasses.replace(cfg, theta_os=2.0)
    consts2 = make_constants(cfg2, np.zeros((3, cfg.m)), np.full((3, cfg.m), 3.0),
                             np.zeros((2, cfg.n)), np.zeros((2, cfg.n)), device="cpu")
    return dict(config=cfg2, consts=consts2)


_MISMATCHES = {
    "thin": lambda: dict(thin=2),
    "burn_iterations": lambda: dict(burn_iterations=4),
    "n_chains": lambda: dict(theta_init=_setup()[1][:2]),
    "config_digest": _changed_config,
}


@pytest.mark.parametrize("key, tempered", [(k, t) for k in sorted(_MISMATCHES)
                                            for t in (False, True)] + [("n_temps", True)])
def test_run_spec_mismatch_raises(partial, key, tempered):
    """JAX's messages, so that its match= strings hold."""
    plain, temp_mgr, resume = partial
    over = dict(n_temps=4) if key == "n_temps" else _MISMATCHES[key]()
    with pytest.raises(ValueError, match=key):
        resume(temp_mgr if tempered else plain, **over)


def test_plain_call_refuses_a_tempered_checkpoint(tmp_path, monkeypatch):
    """A tempered call interrupted mid-burn leaves G L lanes in its file; a
    plain call on the same path raises instead of sampling the hot lanes."""
    _, raw = simulate_2pl(3, n=10, m=5)
    kw = dict(CHAIN=2, SEED=3, dtype="float64", grid_size=101, device="cpu",
              vote_codes={"yea": 1, "nay": 0, "missing": None},
              checkpoint_path=str(tmp_path / "run"), checkpoint_every=2)

    def interrupt(done, total):
        raise Interrupt

    monkeypatch.setattr(api, "_print_progress", interrupt)
    with pytest.raises(Interrupt):
        gpirt_mcmc(raw, SAMPLES, BURN, verbose=True, **TEMPERING, **kw)
    assert CheckpointManager(str(tmp_path / "run.npz")).load().meta["iteration"] == 2
    with pytest.raises(ValueError, match="n_temps: checkpoint=3 vs requested=1"):
        gpirt_mcmc(raw, SAMPLES, BURN, verbose=False, **kw)


def test_resume_across_device_types_raises(partial, tmp_path):
    """The generator's state is specific to its device type: a checkpoint
    whose rng_device is "cuda" does not resume on the CPU, and the message
    names both."""
    plain, _, resume = partial
    ck = plain.load()
    moved = CheckpointManager(str(tmp_path / "moved.npz"))
    moved.save(ck.state, dict(ck.meta, rng_device="cuda"), ck.draws,
               torch.from_numpy(ck.rng_state))
    with pytest.raises(ValueError, match="rng_device: checkpoint='cuda' vs requested='cpu'"):
        resume(moved)


def test_extended_sample_iterations_resume(partial):
    plain, tempered, resume = partial
    assert resume(plain, sample_iterations=6)["theta"].shape[:2] == (K, 6)
    out = resume(tempered, sample_iterations=6)
    assert out["theta"].shape[:2] == (K, 6) and out["swap_rate"].shape == (2,)


def test_foreign_and_stale_files_raise(tmp_path):
    p = str(tmp_path / "stale.npz")
    np.savez(p, foo=np.arange(3))
    with pytest.raises(ValueError, match="not a gpirt checkpoint"):
        CheckpointManager(p).load()
    np.savez(p, meta_json=np.frombuffer(json.dumps({"iteration": 5}).encode(), np.uint8))
    with pytest.raises(ValueError, match="format version"):
        CheckpointManager(p).load()
    meta = {"format_version": CHECKPOINT_FORMAT_VERSION - 1}
    np.savez(p, meta_json=np.frombuffer(json.dumps(meta).encode(), np.uint8))
    with pytest.raises(ValueError, match="format version 2"):
        CheckpointManager(p).load()
    assert CheckpointManager(str(tmp_path / "none.npz")).load() is None


def test_the_packages_read_each_others_files(partial, tmp_path):
    """JAX's manager reads the port's file, state and draws equal; a file
    JAX's manager wrote loads through the port's with equal arrays and no
    generator state, and the port's checkpointed run refuses to resume from it."""
    plain, _, resume = partial
    ck = plain.load()
    assert ck.rng_state.dtype == np.uint8 and ck.meta["iteration"] == 3
    j_state, j_meta, j_draws = JManager(plain.path).load()
    for k in JState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j_state, k)),
                                      getattr(ck.state, k).numpy(), err_msg=k)
    assert sorted(j_draws) == sorted(ck.draws) and j_meta == ck.meta
    for k in ck.draws:
        np.testing.assert_array_equal(j_draws[k], ck.draws[k])

    jax_path = str(tmp_path / "jax.npz")
    state = JState(**{k: jnp.asarray(getattr(ck.state, k).numpy()) for k in JState._fields})
    state = state._replace(theta_idx=state.theta_idx.astype(jnp.int32))
    meta = {k: ck.meta[k] for k in ("thin", "burn_iterations", "n_chains", "store_f",
                                    "store_fstar", "pre_done", "recs_done",
                                    "sample_iterations", "total")}
    JManager(jax_path).save(state, meta, ck.draws)
    got = CheckpointManager(jax_path).load()
    assert got.rng_state is None and got.state.theta_idx.dtype == torch.int64
    for k in JState._fields:
        np.testing.assert_array_equal(getattr(got.state, k).numpy(),
                                      np.asarray(getattr(state, k)), err_msg=k)
    for k in ck.draws:
        np.testing.assert_array_equal(got.draws[k], ck.draws[k])
    with pytest.raises(ValueError, match="no generator state"):
        resume(CheckpointManager(jax_path))


def test_failed_write_keeps_the_previous_checkpoint(partial, monkeypatch):
    plain, _, _ = partial
    before = plain.load()

    def failing_savez(fh, **payload):
        fh.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", failing_savez)
    with pytest.raises(OSError, match="disk full"):
        plain.save(before.state, dict(before.meta, iteration=99), {},
                   torch.from_numpy(before.rng_state))
    monkeypatch.undo()
    after = plain.load()
    assert after.meta == before.meta
    np.testing.assert_array_equal(after.state.f.numpy(), before.state.f.numpy())
    assert glob.glob(os.path.join(os.path.dirname(plain.path), "*.tmp")) == []


def test_complete_checkpoint_returns_its_draws(partial, tmp_path):
    """A resume of a finished run runs no sweep and returns what it saved."""
    plain, _, resume = partial
    first = resume(plain)
    copy = CheckpointManager(str(tmp_path / "copy.npz"))
    shutil.copy(plain.path, copy.path)
    again = resume(copy)
    _assert_draws_equal(again, first)
    assert copy.load().meta["iteration"] == 6 and copy.seconds == 0.0
