"""Item sharding in the port (gpirt_tpu_torch/parallel/items.py and the
sweep's ``item_group``) against the JAX package's ``shard_map``ped item
axis, in float64 on the CPU.

One world of 4 Gloo ranks (``_torch_dist_worker.items_world``) runs every
case of this module on a 2 x 2 (chains x items) mesh, and draw_theta also
on a 1 x 4 one; the JAX side runs here on the conftest's virtual devices,
and the two meet through ``.npz`` files. The port's ranks are fed JAX's own
per-shard draws (the item-local keys fold in the shard's index, theta's
key is replicated, ``gpirt_tpu/models/gibbs.py:2645-2655``), so the
sharded blocks must agree: theta exactly (the summed table differs from
the unsharded one only in summation order, and float64 keeps the Gumbel
argmax clear of it, as ``tests/test_items.py:66-91`` holds for JAX), the
rest to rtol 1e-8 after three sweeps (PERF.md section 2).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_threads  # noqa: F401  (one torch thread a process)
import _torch_dist_worker as w
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.parallel.items import consts_item_specs
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.parallel import distributed as tdist

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

n, m, K, N = w.n, w.m, w.K, w.N
WORLD = 4
_F64 = jnp.float64
_TWO_PI = 6.283185307179586
RTOL = 1e-8
STATE_SPECS = jg.GPIRTState(theta_idx=P(), f=P(None, None, None, "items"),
                            beta=P(None, None, None, "items"),
                            thresholds=P(None, None, "items", None),
                            fstar=P(None, None, None, "items"))


def _y(C, H, seed=0):
    """Ordinal responses from a latent 2PL, 15% missing."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(-1.5, 1.5, n)[None] + 0.4 * rng.standard_normal((H, n))
    latent = theta[..., None] * rng.standard_normal(m) * 1.5 + rng.standard_normal((H, n, m))
    y = (np.digitize(latent, np.quantile(latent, np.arange(1, C) / C)) + 1).astype(np.int32)
    y[rng.random((H, n, m)) < 0.15] = 0
    return y


def _setup(case):
    C, H, ls = w.SWEEP_CASES[case]
    jcfg = JConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                   f_method="conjugate", threshold_ess_twophase=False, theta_ls=ls)
    jconsts = j_make_constants(jcfg, beta_prior_means=np.zeros((3, m)),
                               beta_prior_sds=np.full((3, m), 1.5),
                               theta_prior_means=np.zeros((2, n)),
                               theta_prior_sds=np.full((2, n), 0.5))
    y = _y(C, H)
    rng = np.random.default_rng(1)
    keys = jax.random.split(jax.random.key(7), K)
    jstate = jax.jit(jax.vmap(lambda k, t: jg.init_state(
        k, t, jnp.asarray(default_thresholds(C, m, H)), jnp.asarray(y), jconsts, jcfg)))(
        keys, jnp.asarray(rng.uniform(-2, 2, (K, H, n))))
    if C > 2:  # cutpoints off qnorm(i/C), each lane differently
        d = np.cumsum(np.abs(rng.standard_normal((K, H, m, C - 1))) * 0.3 + 0.2, -1)
        thr = np.asarray(jstate.thresholds).copy()
        thr[..., 1:C] = d - d.mean(-1, keepdims=True)
        jstate = jstate._replace(thresholds=jnp.asarray(thr))
    return jcfg, jconsts, y, keys, jstate


def _theta_uniforms(key, H):
    if H == 1:
        return np.asarray(jg._uniform2d(key, (n, N), _F64))
    return np.stack([np.asarray(jg._uniform2d(k, (n, N), _F64))
                     for k in jax.random.split(key, H)])


def _shard_draws(key, shard, C, H, q, m_loc):
    """One sweep's numbers for item shard ``shard`` replayed from a chain's
    key as JAX's item-sharded conjugate branch consumes them: k_f, k_b and
    k_t fold in the shard, k_th does not."""
    k_f, _, k_th, k_b, k_t = jax.random.split(key, 5)
    k_f, k_b, k_t = (jax.random.fold_in(k, shard) for k in (k_f, k_b, k_t))
    k_u, k_e = jax.random.split(jax.random.fold_in(k_f, 2))
    k_q, k_p, k_n = jax.random.split(k_u, 3)
    k_nu, k_ess = jax.random.split(k_t)
    k_lu, k_eps, k_loop = jax.random.split(k_ess, 3)

    def shrink(k, _):  # ess_update's round loop: key, k_r = split(key)
        k, k_r = jax.random.split(k)
        return k, jax.random.uniform(k_r, (H, m_loc), dtype=_F64)

    k_th = jax.random.fold_in(k_th, 0)
    return dict(
        u_theta=(jg._uniform2d(k_th, (n, N), _F64) if H == 1 else jax.vmap(
            lambda k: jg._uniform2d(k, (n, N), _F64))(jax.random.split(k_th, H))),
        u_z=jg._uniform2d(jax.random.fold_in(k_f, 0), (H, n, m_loc), _F64),
        z_q=jg._normal2d(k_q, (H, q, m_loc), _F64),
        z_p=jg._normal2d(k_p, (H, 3, m_loc), _F64),
        z_n=jg._normal2d(k_n, (H, N, m_loc), _F64),
        eps_f=jg._normal2d(k_e, (H, n, m_loc), _F64),
        zeta=jax.random.normal(k_b, (H, m_loc, 3), _F64),
        nu=jax.random.normal(k_nu, (H, m_loc, C - 1), _F64),
        logu=jnp.log(jax.random.uniform(k_lu, (H, m_loc), dtype=_F64)),
        eps0=jax.random.uniform(k_eps, (H, m_loc), dtype=_F64, maxval=_TWO_PI),
        rs=jax.lax.scan(shrink, k_loop, None, length=64)[1])


def _mesh(S):
    return Mesh(np.asarray(jax.devices()[:S]), ("items",))


def _jax_sweeps(jcfg, jconsts, y, keys, jstate, S=2):
    """Three item-sharded sweeps of the K chains under shard_map."""
    def body(st, ks, yy, cc):
        return jax.vmap(lambda s1, k1: jg.gibbs_sweep(s1, k1, yy, cc, jcfg, None, None,
                                                      "items"))(st, ks)

    fn = jax.jit(shard_map(body, mesh=_mesh(S),
                           in_specs=(STATE_SPECS, P(), P(None, None, "items"),
                                     consts_item_specs(jconsts, "items")),
                           out_specs=(STATE_SPECS, P()), check_vma=False))
    out = []
    for it in range(w.SWEEPS):
        ks = jax.vmap(lambda k: jax.random.fold_in(k, it))(keys)
        jstate, ll = fn(jstate, ks, jnp.asarray(y), jconsts)
        out.append(({f: np.asarray(getattr(jstate, f)) for f in jg.GPIRTState._fields},
                    np.asarray(ll)))
    return out


def _jax_theta(jcfg, jconsts, y, jstate, tkeys, S):
    mu_star = jax.vmap(lambda b: jg.compute_mu_star(jconsts, b))(jstate.beta)

    def body(st, ms, yy, cc, ks):
        return jax.vmap(lambda s1, m1, k1: jg.draw_theta(k1, s1, m1, yy, cc, jcfg, None,
                                                         "items"))(st, ms, ks)

    fn = jax.jit(shard_map(body, mesh=_mesh(S),
                           in_specs=(STATE_SPECS, P(None, None, None, "items"),
                                     P(None, None, "items"),
                                     consts_item_specs(jconsts, "items"), P()),
                           out_specs=P(), check_vma=False))
    return np.asarray(fn(jstate, mu_star, jnp.asarray(y), jconsts, tkeys))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs and JAX's per-shard draws written for the ranks, the
    4-rank world started on them in a thread, and JAX's sharded sweeps and
    theta draws run here meanwhile."""
    tmp = str(tmp_path_factory.mktemp("items_world"))
    cases = {}
    for case, (C, H, _) in w.SWEEP_CASES.items():
        jcfg, jconsts, y, keys, jstate = _setup(case)
        q = jconsts.U_se.shape[1]
        files = {f"c_{f}": np.asarray(v) for f, v in vars(jconsts).items() if v is not None}
        files.update({f"s_{f}": np.asarray(getattr(jstate, f)) for f in jg.GPIRTState._fields})
        tkeys = jax.random.split(jax.random.key(11), K)
        files["y"] = y
        files["theta_u"] = np.stack([_theta_uniforms(k, H) for k in tkeys])
        draws = jax.jit(jax.vmap(lambda k, i: _shard_draws(k, i, C, H, q, m // 2),
                                 in_axes=(0, None)))
        for it in range(w.SWEEPS):
            ks = jax.vmap(lambda k: jax.random.fold_in(k, it))(keys)
            for shard in range(2):
                for name, a in draws(ks, shard).items():  # rs: (R, K, ...)
                    a = np.asarray(a)
                    files[f"it{it}_shard{shard}_{name}"] = (np.moveaxis(a, 0, 1)
                                                            if name == "rs" else a)
        np.savez(os.path.join(tmp, f"sweep_{case}.npz"), **files)
        cases[case] = (jcfg, jconsts, y, keys, jstate, tkeys)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tdist.launch, w.items_world, WORLD, (tmp,), device="cpu",
                            timeout=600)
        want = {}
        for case, (jcfg, jconsts, y, keys, jstate, tkeys) in cases.items():
            want[case] = _jax_sweeps(jcfg, jconsts, y, keys, jstate)
            for tcase, (S, data) in w.THETA_CASES.items():
                if data == case:
                    want[f"theta_{tcase}"] = _jax_theta(jcfg, jconsts, y, jstate, tkeys, S)
        assert ranks.result() == list(range(WORLD))
    ranks = [dict(np.load(os.path.join(tmp, f"items_rank{r}.npz"))) for r in range(WORLD)]
    return want, ranks


def _block(a, z, name, tag="22"):
    """Rank ``z``'s block of a JAX array: its chains, and its items for a
    per-item field."""
    c, i = z[f"place{tag}"]
    nc, ni = (2, 2) if tag == "22" else (1, 4)
    a = a[c * K // nc:(c + 1) * K // nc]
    dim = {"f": -1, "beta": -1, "fstar": -1, "thresholds": -2}.get(name)
    if dim is None:
        return a
    k = a.shape[dim] // ni
    return np.take(a, np.arange(i * k, (i + 1) * k), axis=dim)


def test_item_mesh_layout(world):
    _, ranks = world
    places = set()
    for z in ranks:
        assert list(z["names"]) == ["chains", "items"] and list(z["shape22"]) == [2, 2]
        places.add(tuple(z["place22"]))
        assert tuple(z["place14"]) == (0, len(places) - 1)
    assert places == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("case", list(w.THETA_CASES))
def test_draw_theta_matches_jax(world, case):
    """The item-sharded draw_theta at 2 and 4 item shards (and the GP
    regime's session loop at 2) against JAX's shard_mapped one, given
    JAX's uniforms: theta indices exactly."""
    want, ranks = world
    tag = "22" if w.THETA_CASES[case][0] == 2 else "14"
    for z in ranks:
        np.testing.assert_array_equal(z[f"theta_{case}"],
                                      _block(want[f"theta_{case}"], z, "theta", tag))


@pytest.mark.parametrize("case", list(w.SWEEP_CASES))
def test_sweeps_match_jax(world, case):
    """Three item-sharded sweeps (C = 2; C = 5 with the ordinal cutpoint
    ESS; three sessions in the GP regime) on the 2 x 2 mesh against JAX's
    item-sharded sweep, state by state and ll by ll."""
    want, ranks = world
    for z in ranks:
        for it, (state, ll) in enumerate(want[case]):
            np.testing.assert_array_equal(z[f"{case}_it{it}_theta_idx"],
                                          _block(state["theta_idx"], z, "theta_idx"))
            for f in ("f", "beta", "thresholds", "fstar"):
                np.testing.assert_allclose(z[f"{case}_it{it}_{f}"], _block(state[f], z, f),
                                           rtol=RTOL, atol=RTOL)
            np.testing.assert_allclose(z[f"{case}_it{it}_ll"], _block(ll, z, "ll"),
                                       rtol=RTOL)


@pytest.mark.parametrize("case", list(w.SWEEP_CASES))
def test_sharded_sweep_equals_the_ports_unsharded_sweep(world, case):
    """The port's item-sharded sweep against its own unsharded sweep from
    the same state and the same full draws, cut to the rank's block: the
    table's summation order is the only difference (1e-10)."""
    _, ranks = world
    for z in ranks:
        np.testing.assert_array_equal(z[f"self_{case}_theta_idx"],
                                      z[f"selfref_{case}_theta_idx"])
        for f in ("f", "beta", "thresholds", "fstar", "ll"):
            np.testing.assert_allclose(z[f"self_{case}_{f}"], z[f"selfref_{case}_{f}"],
                                       rtol=1e-10, atol=1e-10)


def test_gpirt_mcmc_on_a_two_by_two_mesh(world):
    """gpirt_mcmc(mesh=make_item_mesh(2, 2), item_axis="items",
    smc_steps=6): the SMC anneal and the sampling both item-sharded; every
    rank returns the same chain dicts in the reference layout, finite."""
    _, ranks = world
    z0 = ranks[0]
    assert z0["mcmc_theta"].shape == (K, 6, n, 1)
    assert z0["mcmc_beta"].shape == (K, 6, 3, m, 1)
    assert z0["mcmc_threshold"].shape == (K, 6, m, 3, 1)
    assert z0["mcmc_ll"].shape == (K, 6) and np.isfinite(z0["mcmc_ll"]).all()
    assert np.isfinite(z0["mcmc_beta"]).all()
    for z in ranks[1:]:
        for k in ("theta", "beta", "threshold", "ll"):
            np.testing.assert_array_equal(z[f"mcmc_{k}"], z0[f"mcmc_{k}"])


def test_item_sharded_checkpoint_resumes_bit_for_bit(world):
    """A checkpointed item-sharded run cut after 2 draws and resumed on the
    same mesh equals the uninterrupted one (the file holds each item
    shard's generator state)."""
    _, ranks = world
    for z in ranks:
        for k in ("theta", "beta", "threshold", "ll"):
            np.testing.assert_array_equal(z[f"ck_resumed_{k}"], z[f"ck_full_{k}"])
            np.testing.assert_array_equal(z[f"ck_full_{k}"], ranks[0][f"ck_full_{k}"])


@pytest.mark.parametrize("case", list(w.REFUSALS))
def test_refusals(world, case):
    """What an item axis refuses, by its own exception: uneven items or
    chains, and tempered groups that do not divide over the chain shards
    (ValueError, as JAX), campaigns that do not divide over a campaign axis
    (ValueError, as JAX), a mesh whose items axis is not named by item_axis
    (ValueError: it would run the same chains on each of its ranks), and a
    respondent axis the mesh does not have (ValueError, as JAX); a sampler
    other than the conjugate one, ESS theta under tempering
    (NotImplementedError, as JAX). The affine moves, which JAX refuses on
    no mesh, run on the 2 x 2 chains x items mesh, and a checkpoint of the
    2 x 2 mesh resumes on 4 item shards and without a mesh (each rank its
    own copy; ``test_torch_resume_counts.py`` checks the streams): their
    gathered draws alike on every rank (the replication canary runs inside).
    ESS theta, tempering and the campaigns run on a mesh too:
    test_torch_mesh_jax.py and test_torch_mesh_tempering.py."""
    _, ranks = world
    if w.REFUSALS[case] is None:  # runs now: its draws alike on every rank
        w.check_runs(ranks, case, (K, 6, n, 1) if case.startswith("resume") else (K, 6, 1, n))
        return
    for z in ranks:
        got = str(z[f"refusal_{case}"])
        assert got.startswith(w.REFUSALS[case] + ":"), got
    names = {"n_temps": "do not divide over 2 chain shards",
             "respondent_axis": "respondent_axis",
             "campaign_mesh": "campaigns do not divide",
             "theta_ess": "tempering needs theta_method='grid'",
             "non_conjugate": "conjugate",
             "uneven_m": "items", "chains_indivisible": "chains",
             "item_axis_not_named": "'items' is neither the chain axis"}
    assert names[case] in str(ranks[0][f"refusal_{case}"])
