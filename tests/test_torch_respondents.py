"""Respondent sharding in the port (gpirt_tpu_torch/parallel/respondents.py,
the sweep's ``respondent_group`` and the low-rank forms of
models/affine.py) against the JAX package's ``shard_map``ped respondent
axis, in float64 on the CPU.

One world of 4 Gloo ranks (``_torch_dist_worker.respondents_world``) runs
every case of this module; the blocks and sweeps on a 4-shard respondent
mesh, the JAX side here on 4 of the conftest's virtual devices, and the two
meet through ``.npz`` files. The port's ranks are fed JAX's own per-shard
draws (theta's, z's and f*'s noise keys fold in the respondent shard's
index, every other key is replicated, ``gpirt_tpu/models/gibbs.py:2656-2661``,
``:2688-2689``, ``:677-678``), so the sharded blocks must agree: each block
to the tolerance ``tests/test_respondents.py`` holds JAX's sharded block to
against its unsharded one, the cutpoints exact where it holds them exact,
and three sweeps at rtol 1e-8 with theta equal (PERF.md section 2).
"""

import dataclasses
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
from gpirt_tpu.parallel.respondents import consts_mesh_specs
from gpirt_tpu_torch.parallel import distributed as tdist
from test_torch_items import _setup, _y

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

n, m, K, N = w.n, w.m, w.K, w.N
WORLD = S = 4  # ranks, and respondent shards of the block and sweep cases
n_loc = n // S
RAX = "respondents"
_F64 = jnp.float64
_TWO_PI = 6.283185307179586
RTOL = 1e-8
STATE_SPECS = jg.GPIRTState(theta_idx=P(None, None, RAX), f=P(None, None, RAX, None),
                            beta=P(), thresholds=P(), fstar=P())


def _mesh():
    return Mesh(np.asarray(jax.devices()[:S]), (RAX,))


def _sharded(fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=_mesh(), in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def _ess_loop(key, shape, rounds=64):
    """ess_update's uniforms from ``key``: logu, eps0, rs (rounds, ...)."""
    k_u, k_eps, k_loop = jax.random.split(key, 3)

    def shrink(k, _):
        k, k_r = jax.random.split(k)
        return k, jax.random.uniform(k_r, shape, dtype=_F64)

    return (jnp.log(jax.random.uniform(k_u, shape, dtype=_F64)),
            jax.random.uniform(k_eps, shape, dtype=_F64, maxval=_TWO_PI),
            jax.lax.scan(shrink, k_loop, None, length=rounds)[1])


def _lanes(per_chain, axis=0):
    """Per-chain numbers (K, ...) with the chain axis moved to ``axis``."""
    return np.moveaxis(np.asarray(per_chain), 0, axis)


def _sweep_shard_draws(key, shard, C, H, q):
    """One sweep's numbers for respondent shard ``shard`` replayed from a
    chain's key as JAX's respondent-sharded conjugate branch consumes them:
    k_th, z's key and f*'s noise key fold in the shard, the rest do not."""
    k_f, _, k_th, k_b, k_t = jax.random.split(key, 5)
    k_th = jax.random.fold_in(jax.random.fold_in(k_th, shard), 0)
    k_u, k_e = jax.random.split(jax.random.fold_in(k_f, 2))
    k_q, k_p, k_n = jax.random.split(k_u, 3)
    k_nu, k_ess = jax.random.split(k_t)
    logu, eps0, rs = _ess_loop(k_ess, (H, m))
    return dict(
        u_theta=(jg._uniform2d(k_th, (n_loc, N), _F64) if H == 1 else jax.vmap(
            lambda k: jg._uniform2d(k, (n_loc, N), _F64))(jax.random.split(k_th, H))),
        u_z=jg._uniform2d(jax.random.fold_in(jax.random.fold_in(k_f, 0), shard),
                          (H, n_loc, m), _F64),
        z_q=jg._normal2d(k_q, (H, q, m), _F64),
        z_p=jg._normal2d(k_p, (H, 3, m), _F64),
        z_n=jg._normal2d(k_n, (H, N, m), _F64),
        eps_f=jg._normal2d(jax.random.fold_in(k_e, shard), (H, n_loc, m), _F64),
        zeta=jax.random.normal(k_b, (H, m, 3), _F64),
        nu=jax.random.normal(k_nu, (H, m, C - 1), _F64),
        logu=logu, eps0=eps0, rs=rs)


def _jax_sweeps(jcfg, jconsts, y, keys, jstate, temps=None):
    """Three respondent-sharded sweeps of the K chains under shard_map, at
    T = 1 or at ``temps``, one temperature a chain."""
    def body(st, ks, yy, cc, tt):
        return jax.vmap(lambda s1, k1, t1: jg.gibbs_sweep(s1, k1, yy, cc, jcfg, t1, None,
                                                          None, RAX),
                        in_axes=(0, 0, None if temps is None else 0))(st, ks, tt)

    fn = _sharded(body, (STATE_SPECS, P(), P(None, RAX, None),
                         consts_mesh_specs(jconsts, None, RAX), P()), (STATE_SPECS, P()))
    tt = None if temps is None else jnp.asarray(temps, _F64)
    out = []
    for it in range(w.SWEEPS):
        ks = jax.vmap(lambda k: jax.random.fold_in(k, it))(keys)
        jstate, ll = fn(jstate, ks, jnp.asarray(y), jconsts, tt)
        out.append(({f: np.asarray(getattr(jstate, f)) for f in jg.GPIRTState._fields},
                    np.asarray(ll)))
    return out


def _block_inputs(tmp):
    """The inputs and JAX's numbers of the block cases, written for the
    ranks, and a function that runs JAX's sharded blocks on them."""
    jcfg, jconsts, y2, _, _ = _setup("C2")
    gcfg, gconsts, _, _, _ = _setup("gp_H3")
    q = jconsts.U_se.shape[1]
    rng = np.random.default_rng(3)
    keys = jax.random.split(jax.random.key(21), K)
    f = {f"c_{k}": np.asarray(v) for k, v in vars(jconsts).items() if v is not None}
    f["lr_idx"] = rng.integers(0, N, (K, 1, n))
    f["lr_r"] = rng.normal(size=(K, 1, n, m))
    for tag, H in (("session", 1), ("pooled", 3)):
        f[f"fs_{tag}_idx"] = rng.integers(0, N, (K, H, n))
        f[f"fs_{tag}_zr"] = rng.normal(size=(K, H, n, m))
        k_u = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
        k_e = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
        Hi = 1 if tag == "pooled" else H
        kq, kp, kn = (jax.vmap(lambda k, i=i: jax.random.split(k, 3)[i])(k_u)
                      for i in range(3))
        for name, kk, shape in (("z_q", kq, (q, m)), ("z_p", kp, (3, m)), ("z_n", kn, (N, m))):
            a = jax.vmap(lambda k, s=shape: jg._normal2d(k, (Hi,) + s if tag == "session"
                                                         else s, _F64))(kk)
            f[f"fs_{tag}_{name}"] = np.asarray(a).reshape((K, Hi) + shape)
        for r in range(S):
            f[f"fs_{tag}_eps_r{r}"] = np.asarray(jax.vmap(lambda k, r=r: jg._normal2d(
                jax.random.fold_in(k, r), (H, n_loc, m), _F64))(k_e))
    f["b_theta"] = rng.normal(size=(K, 1, n))
    f["b_zmf"] = rng.normal(size=(K, 1, n, m))
    f["b_zeta"] = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (1, m, 3), _F64))(keys))
    ys = {2: y2, 4: _y(4, 1, seed=4)}
    for C in (2, 4):
        f[f"t{C}_y"] = ys[C]
        f[f"t{C}_f"] = rng.normal(size=(K, 1, n, m))
        f[f"t{C}_mu"] = 0.1 * rng.normal(size=(K, 1, n, m))
        d = np.cumsum(np.abs(rng.standard_normal((K, 1, m, C - 1))) * 0.3 + 0.2, -1)
        thr = np.zeros((K, 1, m, C + 1))
        thr[..., 0], thr[..., C] = -np.inf, np.inf
        thr[..., 1:C] = d - d.mean(-1, keepdims=True) + 0.3 * rng.normal(size=(K, 1, m, 1))
        f[f"t{C}_thr"] = thr
        k_nu = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
        k_ess = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
        f[f"t{C}_nu"] = np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (1, m, C - 1), _F64))(k_nu))
        logu, eps0, rs = jax.vmap(lambda k: _ess_loop(k, (1, m)))(k_ess)
        f[f"t{C}_logu"], f[f"t{C}_eps0"], f[f"t{C}_rs"] = (
            np.asarray(logu), np.asarray(eps0), _lanes(rs, 1))
        nz, nlu = [], []
        for c in range(K):
            zs, lus, kc = [], [], keys[c]
            for t in range(2):  # threshold_mh_tries
                k_z, k_uu, kc = jax.random.split(jax.random.fold_in(kc, t), 3)
                zs.append(np.asarray(jax.random.normal(k_z, (1, m, C - 1), _F64)))
                lus.append(np.log(np.asarray(jax.random.uniform(k_uu, (1, m), _F64))))
            nz.append(zs)
            nlu.append(lus)
        f[f"t{C}_nz"], f[f"t{C}_nlogu"] = _lanes(nz, 1), _lanes(nlu, 1)
    y2a = np.asarray(y2)
    f["c_z"] = np.where(y2a == 2, np.abs(rng.normal(size=(K, 1, n, m))) + 0.01,
                        -np.abs(rng.normal(size=(K, 1, n, m))) - 0.01)
    f["c_u"] = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (1, m, 1), _F64))(
        keys))[..., 0]
    Wa, Ra = 3, 4
    f["a_idx"] = rng.integers(20, N - 20, (K, 1, n))
    f["a_z"] = rng.normal(size=(K, 1, n, m))
    f["a_beta"] = 0.3 * rng.normal(size=(K, 1, 3, m))
    pick, acc, ell, udil = [], [], [], []
    for k in keys:
        k_shift, k_dil = jax.random.split(k)
        k_pick, k_acc = jax.random.split(k_shift)
        pick.append(np.asarray(jax.random.uniform(k_pick, (1, 2 * Wa + 1), _F64))[0])
        acc.append(np.asarray(jax.random.uniform(k_acc, (), _F64)))
        pairs = [jax.random.split(kk) for kk in jax.random.split(k_dil, Ra)]
        ell.append([np.asarray(jax.random.normal(kd, (), _F64)) for kd, _ in pairs])
        udil.append([np.asarray(jax.random.uniform(ku, (), _F64)) for _, ku in pairs])
    f["a_u_pick"], f["a_u_acc"] = np.stack(pick), np.stack(acc)
    f["a_ell"], f["a_u_dil"] = _lanes(ell, 1), _lanes(udil, 1)
    np.savez(os.path.join(tmp, "resp_blocks.npz"), **f)

    def run():
        cs = consts_mesh_specs(jconsts, None, RAX)
        gs = consts_mesh_specs(gconsts, None, RAX)
        R1, R2 = P(None, None, RAX), P(None, None, RAX, None)
        J = jnp.asarray
        want = {}
        x, ld = _sharded(lambda i, r, c: jax.vmap(
            lambda ii, rr: jg.lowrank_bsolve(ii, c, rr, psum_axis=RAX))(i, r),
            (R1, R2, cs), (R2, P()))(J(f["lr_idx"]), J(f["lr_r"]), jconsts)
        want["lowrank_x"], want["lowrank_logdet"] = np.asarray(x), np.asarray(ld)
        for tag, cfg, cc, spec in (("session", jcfg, jconsts, cs),
                                   ("pooled", dataclasses.replace(
                                       gcfg, constant_IRF=True), gconsts, gs)):
            def fs(i, zr, c, ks, cfg=cfg):
                def one(k, ii, zz):
                    st = jg.GPIRTState(ii, zz, None, None, None)
                    return jg.draw_fstar_conjugate(k, st, zz, cfg, c, None, RAX)
                return jax.vmap(one)(ks, i, zr)
            got = _sharded(fs, (R1, R2, spec, P()), (P(), R2))(
                J(f[f"fs_{tag}_idx"]), J(f[f"fs_{tag}_zr"]), cc, keys)
            want[f"fstar_{tag}"], want[f"fstar_{tag}_f"] = (np.asarray(a) for a in got)
        want["beta"] = np.asarray(_sharded(lambda t, z, c, ks: jax.vmap(
            lambda k, tt, zz: jg.draw_beta_conjugate(k, tt, zz, c, jcfg, None, RAX))(
                ks, t, z), (R1, R2, cs, P()), P())(J(f["b_theta"]), J(f["b_zmf"]), jconsts,
                                                   keys))
        for C in (2, 4):
            for method in ("ess", "newton"):
                cfg = dataclasses.replace(jcfg, C=C, threshold_method=method)

                def th(thr, ff, mu, yy, ks, cfg=cfg):
                    return jax.vmap(lambda k, t, a, b: jg.draw_threshold(
                        k, t, a, b, yy, cfg, None, RAX))(ks, thr, ff, mu)
                want[f"{method}_C{C}"] = np.asarray(_sharded(
                    th, (P(), R2, R2, P(None, RAX, None), P()), P())(
                        J(f[f"t{C}_thr"]), J(f[f"t{C}_f"]), J(f[f"t{C}_mu"]),
                        J(f[f"t{C}_y"]), keys))
        want["collapsed"] = np.asarray(_sharded(lambda thr, z, yy, ks: jax.vmap(
            lambda k, t, zz: jg.draw_threshold_collapsed(k, t, zz, yy, jcfg, RAX))(
                ks, thr, z), (P(), R2, P(None, RAX, None), P()), P())(
            J(f["t2_thr"]), J(f["c_z"]), J(f["t2_y"]), keys))
        acfg = dataclasses.replace(jcfg, affine_shift_max=Wa, affine_rounds=Ra)
        idx, beta = _sharded(lambda i, z, b, c, ks: jax.vmap(
            lambda k, ii, zz, bb: jg.affine_theta_moves(k, ii, zz, bb, c, acfg, None, None,
                                                        RAX))(ks, i, z, b),
            (R1, R2, P(), cs, P()), (R1, P()))(
            J(f["a_idx"]), J(f["a_z"]), J(f["a_beta"]), jconsts, keys)
        want["affine_idx"], want["affine_beta"] = np.asarray(idx), np.asarray(beta)
        want["affine_in"] = f["a_idx"]
        return want

    return run


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs and JAX's per-shard draws written for the ranks, the
    4-rank world started on them in a thread, and JAX's sharded blocks and
    sweeps run here meanwhile."""
    tmp = str(tmp_path_factory.mktemp("respondents_world"))
    blocks = _block_inputs(tmp)
    cases = {}
    for case, (C, H, _) in w.SWEEP_CASES.items():
        jcfg, jconsts, y, keys, jstate = _setup(case)
        q = jconsts.U_se.shape[1]
        files = {f"c_{f}": np.asarray(v) for f, v in vars(jconsts).items() if v is not None}
        files.update({f"s_{f}": np.asarray(getattr(jstate, f)) for f in jg.GPIRTState._fields})
        files["y"] = y
        draws = jax.jit(jax.vmap(lambda k, s: _sweep_shard_draws(k, s, C, H, q),
                                 in_axes=(0, None)))
        for it in range(w.SWEEPS):
            ks = jax.vmap(lambda k: jax.random.fold_in(k, it))(keys)
            for shard in range(S):
                for name, a in draws(ks, shard).items():
                    files[f"resp_it{it}_shard{shard}_{name}"] = _lanes(a, 1) if name == "rs" \
                        else np.asarray(a)
        np.savez(os.path.join(tmp, f"sweep_{case}.npz"), **files)
        cases[case] = (jcfg, jconsts, y, keys, jstate)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tdist.launch, w.respondents_world, WORLD, (tmp,), device="cpu",
                            timeout=600)
        want = blocks()
        for label, (case, temps) in w.RESP_SWEEP_CASES.items():
            want[label] = _jax_sweeps(*cases[case], temps)
        assert ranks.result() == list(range(WORLD))
    ranks = [dict(np.load(os.path.join(tmp, f"resp_rank{r}.npz"))) for r in range(WORLD)]
    return want, ranks


def _rows(a, z, dim):
    """Rank ``z``'s respondent block of a JAX array along ``dim``."""
    r = int(z["place_r4"][2])
    return np.take(a, np.arange(r * n_loc, (r + 1) * n_loc), axis=dim)


def test_respondent_mesh_layouts(world):
    """make_respondent_mesh drops the axes of size 1, and the ranks take
    every place of each mesh."""
    _, ranks = world
    assert list(ranks[0]["names_r4"]) == [RAX]
    assert list(ranks[0]["names_cr"]) == ["chains", RAX]
    assert list(ranks[0]["names_ir"]) == ["items", RAX]
    for tag, places in (("r4", {(0, 0, r) for r in range(4)}),
                        ("cr", {(c, 0, r) for c in range(2) for r in range(2)}),
                        ("ir", {(0, i, r) for i in range(2) for r in range(2)})):
        assert {tuple(z[f"place_{tag}"]) for z in ranks} == places


def test_lowrank_bsolve_matches_jax(world):
    """lowrank_bsolve with its U^T contractions summed over the respondent
    shards against JAX's psum'd one: x at rtol 1e-9, log det B at 1e-12."""
    want, ranks = world
    for z in ranks:
        np.testing.assert_allclose(z["lowrank_x"], _rows(want["lowrank_x"], z, -2),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(z["lowrank_logdet"], want["lowrank_logdet"], rtol=1e-12)


@pytest.mark.parametrize("tag", ["session", "pooled"])
def test_fstar_conjugate_matches_jax(world, tag):
    """draw_fstar_conjugate per session (H = 1) and pooled under
    constant_IRF (H = 3, one capacitance over the sessions' sites), its
    projection and capacitance summed over the shards, fed JAX's numbers:
    f* at rtol 1e-8, and f at the shard's sites."""
    want, ranks = world
    for z in ranks:
        np.testing.assert_allclose(z[f"fstar_{tag}"], want[f"fstar_{tag}"], rtol=RTOL,
                                   atol=RTOL)
        np.testing.assert_allclose(z[f"fstar_{tag}_f"], _rows(want[f"fstar_{tag}_f"], z, -2),
                                   rtol=RTOL, atol=RTOL)


def test_beta_conjugate_matches_jax(world):
    """draw_beta_conjugate with the global standardisation moments and the
    regression sums all-reduced: rtol 1e-8."""
    want, ranks = world
    for z in ranks:
        np.testing.assert_allclose(z["beta"], want["beta"], rtol=RTOL, atol=1e-10)


@pytest.mark.parametrize("method", ["ess", "newton"])
@pytest.mark.parametrize("C", [2, 4])
def test_cutpoints_match_jax(world, method, C):
    """The y-marginal ESS (binary: the plain round loop with its lane
    totals all-reduced each round, not the kernel) and Newton-proposal MH
    with its data sums all-reduced, at C = 2 and 4, against JAX's psum'd
    updates: rtol 1e-10, as ``tests/test_respondents.py`` holds JAX's own
    sharded update to its unsharded one."""
    want, ranks = world
    for z in ranks:
        got, ref = z[f"{method}_C{C}"], want[f"{method}_C{C}"]
        inner = slice(1, C)
        np.testing.assert_allclose(got[..., inner], ref[..., inner], rtol=1e-10, atol=1e-12)


def test_collapsed_cutpoints_match_jax(world):
    """The collapsed draw's z box by MAX over the shards: the cutpoints as
    exact as JAX's test holds them (rtol 1e-12, atol 0)."""
    want, ranks = world
    for z in ranks:
        np.testing.assert_allclose(z["collapsed"][..., 1], want["collapsed"][..., 1],
                                   rtol=1e-12, atol=0)


def test_affine_moves_match_jax(world):
    """The shift orbit and dilation rounds on a respondent-only mesh
    through the low-rank z-marginal, fed JAX's replicated numbers: theta
    indices exactly equal, beta at rtol 1e-10."""
    want, ranks = world
    for z in ranks:
        np.testing.assert_array_equal(z["affine_idx"], _rows(want["affine_idx"], z, -1))
        np.testing.assert_allclose(z["affine_beta"], want["affine_beta"], rtol=1e-10,
                                   atol=1e-12)
    assert (want["affine_idx"] != want["affine_in"]).any(axis=(1, 2)).sum() >= 2


@pytest.mark.parametrize("case", list(w.RESP_SWEEP_CASES))
def test_sweeps_match_jax(world, case):
    """Three respondent-sharded sweeps (C = 2; C = 5 with the ordinal
    cutpoint ESS; three sessions in the GP regime; C = 2 and C = 5
    tempered, one temperature a chain) on 4 shards against JAX's
    respondent-sharded sweep, state by state and ll by ll: theta exactly,
    the rest at rtol 1e-8."""
    want, ranks = world
    for z in ranks:
        for it, (state, ll) in enumerate(want[case]):
            np.testing.assert_array_equal(z[f"{case}_it{it}_theta_idx"],
                                          _rows(state["theta_idx"], z, -1))
            np.testing.assert_allclose(z[f"{case}_it{it}_f"], _rows(state["f"], z, -2),
                                       rtol=RTOL, atol=RTOL)
            for f in ("beta", "thresholds", "fstar"):
                np.testing.assert_allclose(z[f"{case}_it{it}_{f}"], state[f], rtol=RTOL,
                                           atol=RTOL)
            np.testing.assert_allclose(z[f"{case}_it{it}_ll"], ll, rtol=RTOL)


@pytest.mark.parametrize("case", list(w.RESP_SWEEP_CASES))
def test_replicated_fields_identical_on_every_shard(world, case):
    """After each sweep beta, the cutpoints and f* are bit for bit the same
    on every respondent shard (the design's precondition,
    ``gpirt_tpu/models/gibbs.py:873-883``), and so is the ll."""
    _, ranks = world
    for it in range(w.SWEEPS):
        for f in ("beta", "thresholds", "fstar", "ll"):
            for z in ranks[1:]:
                np.testing.assert_array_equal(z[f"{case}_it{it}_{f}"],
                                              ranks[0][f"{case}_it{it}_{f}"])


@pytest.mark.parametrize("label", list(w.RESP_SELF_CASES))
def test_sharded_sweep_equals_the_ports_unsharded_sweep(world, label):
    """The port's respondent-sharded sweep against its own unsharded sweep
    from the same state and the same full draws, cut to the rank's block
    (the three sweep cases, the affine moves through the low-rank
    z-marginal against the dense one, theta by ESS, the collapsed and the
    Newton cutpoints): theta equal, the rest within 1e-10 (summation
    order)."""
    _, ranks = world
    for z in ranks:
        np.testing.assert_array_equal(z[f"self_{label}_theta_idx"],
                                      z[f"selfref_{label}_theta_idx"])
        for f in ("f", "beta", "thresholds", "fstar", "ll"):
            np.testing.assert_allclose(z[f"self_{label}_{f}"], z[f"selfref_{label}_{f}"],
                                       rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("tag", ["r4", "cr"])
def test_anneal_on_respondent_mesh_equals_unsharded(world, tag):
    """anneal_init (8 chains, 6 steps from T = 8) on a 4-shard respondent
    mesh and on a 2 x 2 chains x respondents mesh, fed the unsharded
    anneal's numbers cut to each rank's respondents, against the port's
    unsharded anneal_init from the same seed: the weight-ESS trace, the
    resample count and the final weight ESS equal to 1e-10 on every rank
    (the reweight's ll summed over the shards), theta exactly, the rest of
    the rank's block within 1e-10, and at least one resample before the
    final one."""
    _, ranks = world
    for z in ranks:
        for k in ("weight_ess", "final_weight_ess"):
            np.testing.assert_allclose(z[f"anneal_{tag}_{k}"], z[f"annealref_{tag}_{k}"],
                                       rtol=1e-10, atol=0)
        assert z[f"anneal_{tag}_n_resamples"] == z[f"annealref_{tag}_n_resamples"] >= 2
        np.testing.assert_array_equal(z[f"anneal_{tag}_theta_idx"],
                                      z[f"annealref_{tag}_theta_idx"])
        for f in ("f", "beta", "thresholds", "fstar"):
            np.testing.assert_allclose(z[f"anneal_{tag}_{f}"], z[f"annealref_{tag}_{f}"],
                                       rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("tag", ["r4", "cr", "ir"])
def test_gpirt_mcmc_on_respondent_meshes(world, tag):
    """gpirt_mcmc(mesh=..., respondent_axis="respondents") on a 4-shard
    respondent mesh and a 2 x 2 chains x respondents mesh, both with the
    SMC anneal, and on a 1 x 2 x 2 chains x items x respondents mesh with f
    stored: every rank returns the same chain dicts in the reference
    layout, finite."""
    _, ranks = world
    z0 = ranks[0]
    assert z0[f"mcmc_{tag}_theta"].shape == (K, 6, n, 1)
    assert z0[f"mcmc_{tag}_beta"].shape == (K, 6, 3, m, 1)
    assert z0[f"mcmc_{tag}_threshold"].shape == (K, 6, m, 3, 1)
    assert np.isfinite(z0[f"mcmc_{tag}_ll"]).all() and np.isfinite(z0[f"mcmc_{tag}_beta"]).all()
    if tag == "ir":
        assert z0["mcmc_ir_f"].shape == (K, 6, n, m, 1) and np.isfinite(z0["mcmc_ir_f"]).all()
    for z in ranks[1:]:
        for k in ("theta", "beta", "threshold", "ll"):
            np.testing.assert_array_equal(z[f"mcmc_{tag}_{k}"], z0[f"mcmc_{tag}_{k}"])


@pytest.mark.parametrize("tag", ["cr", "ir"])
def test_respondent_sharded_checkpoint_resumes_bit_for_bit(world, tag):
    """A checkpointed run on the 2 x 2 chains x respondents mesh and on the
    items x respondents one (its cell generators saved too) cut after 2
    draws and resumed on the same mesh equals the uninterrupted run."""
    _, ranks = world
    for z in ranks:
        for k in ("theta", "beta", "threshold", "ll"):
            np.testing.assert_array_equal(z[f"ck_resumed_{tag}_{k}"], z[f"ck_full_{tag}_{k}"])
            np.testing.assert_array_equal(z[f"ck_full_{tag}_{k}"], ranks[0][f"ck_full_{tag}_{k}"])


@pytest.mark.parametrize("case", list(w.RESP_REFUSALS))
def test_refusals(world, case):
    """What a respondent axis refuses, by its own exception: uneven
    respondents, and tempered groups that do not divide over the chain
    shards (ValueError, as JAX); a sampler other than the conjugate one
    (NotImplementedError). The affine moves on the 1 x 2 x 2 chains x
    items x respondents mesh, which JAX refuses on no mesh, run, and so
    does a checkpoint of the 2 x 2 chains x respondents mesh resumed on 4
    respondent shards and without a mesh (each rank its own copy;
    ``test_torch_resume_counts.py`` checks the streams): their gathered
    draws alike on every rank (the replication canary runs inside). Tempering runs too:
    test_torch_mesh_tempering.py and test_torch_mesh_jax.py."""
    _, ranks = world
    if w.RESP_REFUSALS[case] is None:  # runs now: its draws alike on every rank
        w.check_runs(ranks, case, (K, 6, n, 1) if case.startswith("resume") else (K, 6, 1, n))
        return
    for z in ranks:
        got = str(z[f"refusal_{case}"])
        assert got.startswith(w.RESP_REFUSALS[case] + ":"), got
    names = {"uneven_n": "respondents do not divide", "non_conjugate": "conjugate",
             "n_temps": "do not divide over 2 chain shards"}
    assert names[case] in str(ranks[0][f"refusal_{case}"])


@pytest.mark.parametrize("per_chain_c", [False, True])
def test_binary_ess_over_respondents_matches_the_plain_version(per_chain_c):
    """The respondent path's binary cutpoint ESS, its rounds summing only
    the active lanes, against the kernel's plain
    version on the same lanes and numbers (float64, one process: the lane
    totals' all_reduce is the identity), with one c and with one a chain."""
    import torch

    from gpirt_tpu_torch.models import gibbs as tg
    from gpirt_tpu_torch.ops.threshold_ess import binary_threshold_ess_reference

    gen = torch.Generator().manual_seed(4)
    Kc, H, nn, mm, R = 3, 2, 40, 7, 64
    g = torch.randn(Kc, H, nn, mm, generator=gen, dtype=torch.float64)
    y = torch.randint(0, 3, (H, nn, mm), generator=gen, dtype=torch.int32)
    t1, nu = (torch.randn(Kc, H, mm, generator=gen, dtype=torch.float64) for _ in range(2))
    logu = torch.log(torch.rand(Kc, H, mm, generator=gen, dtype=torch.float64))
    eps0 = torch.rand(Kc, H, mm, generator=gen, dtype=torch.float64) * _TWO_PI
    rs = torch.rand(R, Kc, H, mm, generator=gen, dtype=torch.float64)
    c = (0.7071067811865476 / torch.sqrt(torch.tensor([1.0, 4.0, 16.0], dtype=torch.float64))
         if per_chain_c else 0.7071067811865476)
    want = binary_threshold_ess_reference(g, y, t1, nu, logu, eps0, rs, c)
    got = tg._binary_ess_over_respondents(g, y, t1, nu, logu, eps0, rs, c, None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    assert (got != t1).float().mean() > 0.8


def test_basin_study_at_reduced_size(capsys):
    """``chip_smoke.py --basins``' study on the CPU at 4 chains of a 20 x 8
    matrix, SMC 3 steps, burn 2 and 4 draws, seeds 1-3, the sharded runs
    the stages of one world of 2 Gloo ranks: a share a seed for each
    sampler (the first seed's unsharded run, the basin's own, left out),
    each in [0, 1], and a line a run. (Here, not beside the other
    reduced-size phases: ``--dist loadfile`` runs each file on one worker,
    and test_torch_chip_smoke.py is already the suite's longest.)"""
    import torch

    import chip_smoke
    from test_torch_chip_smoke import _small_votes

    shares = chip_smoke.basin_study(_small_votes(), torch.device("cpu"), "cpu", [1, 2, 3],
                                    chains=4, burn=2, draws=4, smc_steps=3)
    assert len(shares["unsharded"]) == 2 and len(shares["sharded"]) == 3
    assert all(0.0 <= x <= 1.0 for v in shares.values() for x in v)
    text = capsys.readouterr().out
    for label in ("unsharded", "sharded"):
        for s in (1, 2, 3):
            assert f"  {label} SEED {s}: pooled r " in text
    assert "runs with a majority there: unsharded" in text
