"""The port's examples (examples/torch_senate116_walkthrough.py and
examples/torch_sdo_ordinal.py) on the CPU: each main() at a tiny size,
their gpirt_mcmc calls against the JAX examples' (the same data and
arguments), and imports that leave JAX out."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_threads  # noqa: F401  (one torch thread a process)
import gpirt_tpu
import gpirt_tpu.utils.cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--iters", "6", "--burn", "2", "--device", "cpu"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_walkthrough_runs_at_a_tiny_size(capsys):
    out = _example("torch_senate116_walkthrough").main(TINY + ["--chains", "2"])
    n = out["senators"].size
    assert n == 100 and out["theta_hat"].shape == (n,)
    assert out["chain_means"].shape == (2, n)
    assert np.isfinite(out["theta_hat"]).all() and np.ptp(out["theta_hat"]) > 0
    assert out["ess_pooled"] > 0 and out["ess_within"] > 0
    assert out["rhat_max"] >= 1.0 and out["seconds"] > 0
    text = capsys.readouterr().out
    assert "response matrix: 100 senators x 418 roll calls" in text
    assert "split R-hat: max" in text and "most liberal (lowest theta):" in text


def test_sdo_example_runs_at_a_tiny_size(capsys):
    out = _example("torch_sdo_ordinal").main(TINY + ["--rows", "60"])
    assert out["cutpoints"].shape == (16, 4) and out["irf"].shape == (3,)
    assert out["theta_mean"].shape == (60,) and out["ll"].shape == (6,)
    for k in ("cutpoints", "irf", "theta_mean", "ll"):
        assert np.isfinite(out[k]).all(), k
    assert (np.diff(out["cutpoints"], axis=-1) > 0).all()
    text = capsys.readouterr().out
    assert "SDO: 60 respondents x 16 items, codes 1..5" in text
    assert "posterior-mean cutpoints, item 1:" in text


class _Called(Exception):
    pass


def _call_of(run, module, monkeypatch):
    """The (args, kwargs) of the first gpirt_mcmc call ``run()`` makes
    through ``module.gpirt_mcmc``, which it does not get to run."""
    seen = {}

    def record(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        raise _Called

    monkeypatch.setattr(module, "gpirt_mcmc", record)
    with pytest.raises(_Called):
        run()
    return seen["args"], seen["kwargs"]


@pytest.mark.parametrize("name, argv", [
    ("senate116_walkthrough", []),
    ("senate116_walkthrough", ["--iters", "40", "--burn", "9", "--chains", "3"]),
    ("sdo_ordinal", []),
    ("sdo_ordinal", ["--iters", "40", "--burn", "9", "--rows", "70"]),
])
def test_example_calls_gpirt_mcmc_as_the_jax_example(name, argv, monkeypatch):
    """The port's example passes gpirt_mcmc the data and arguments the JAX
    example passes (and device=), at the defaults and at other sizes."""
    monkeypatch.setattr(gpirt_tpu.utils.cache, "enable_persistent_cache", lambda: None)
    jax_ex = _example(name)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    j_args, j_kw = _call_of(jax_ex.main, gpirt_tpu, monkeypatch)
    port = _example(f"torch_{name}")
    t_args, t_kw = _call_of(lambda: port.main(argv + ["--device", "cpu"]), port,
                            monkeypatch)
    assert t_kw.pop("device") == "cpu"
    assert t_kw == j_kw
    assert len(t_args) == len(j_args) == 1
    np.testing.assert_array_equal(np.asarray(t_args[0]), np.asarray(j_args[0]))
    assert np.isnan(np.asarray(t_args[0])).any()


@pytest.mark.parametrize("name", ["torch_senate116_walkthrough", "torch_sdo_ordinal"])
def test_importing_an_example_leaves_jax_out(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    code = ("import importlib.util, sys; "
            f"spec = importlib.util.spec_from_file_location('ex', {path!r}); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'gpirt_tpu' or m.startswith('gpirt_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
