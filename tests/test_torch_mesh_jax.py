"""ESS theta and the affine moves under an item axis, and tempering's swap
phase on model axes, in the port against the JAX package's ``shard_map``ped
code, in float64 on the CPU.

One world of 4 Gloo ranks (``_torch_mesh_worker.jax_mesh_world``) runs every
case of this module; the JAX side runs here on the conftest's virtual
devices, and the two meet through ``.npz`` files. The port's ranks are fed
JAX's own numbers: theta's ESS numbers and the affine moves' from the
replicated keys (``gpirt_tpu/models/gibbs.py:2645-2655``; the affine key is
``k_f_repl``), every other item-local one from the keys that fold in the
item shard's index. So the sharded blocks must agree: theta exactly, beta
to rtol 1e-12 after the affine moves (``tests/test_items.py:267-293``), the
rest to rtol 1e-8 after three sweeps (PERF.md section 2), and a swap
phase's accept decisions exactly with its ll to rtol 1e-10.
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
import _torch_mesh_worker as mw
from gpirt_tpu.models import gibbs as jg
from gpirt_tpu.models.config import GPIRTConfig as JConfig
from gpirt_tpu.models.config import make_constants as j_make_constants
from gpirt_tpu.parallel import tempering as jt
from gpirt_tpu.parallel.respondents import consts_mesh_specs
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.parallel import distributed as tdist
from test_torch_items import _y

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

n, m, K, N = w.n, w.m, w.K, w.N
WORLD = 4
IAX, RAX = "items", "respondents"
_F64 = jnp.float64
_TWO_PI = 6.283185307179586
RTOL = 1e-8
# each JAX mesh: (devices, axis names) and the port mesh whose blocks it holds
JAX_MESHES = {"ci22": ((2,), (IAX,)), "i14": ((4,), (IAX,)), "ir22": ((2, 2), (IAX, RAX)),
              "cr22": ((2,), (RAX,))}


def _mesh(tag):
    shape, names = JAX_MESHES[tag]
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _axes(tag):
    names = JAX_MESHES[tag][1]
    return (IAX if IAX in names else None), (RAX if RAX in names else None)


def _state_specs(iax, rax):
    return jg.GPIRTState(theta_idx=P(None, None, rax), f=P(None, None, rax, iax),
                         beta=P(None, None, None, iax), thresholds=P(None, None, iax, None),
                         fstar=P(None, None, None, iax))


def _sharded(tag, fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=_mesh(tag), in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def _setup(case, **opts):
    """JAX's config, constants, y, chain keys and a spread state of a case."""
    C, H, ls = mw.CASES[case]
    jcfg = JConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                   f_method="conjugate", threshold_ess_twophase=False, theta_ls=ls, **opts)
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
    return jcfg, jconsts, y, keys, jstate


def _ess_loop(key, shape, rounds=64):
    """ess_update's uniforms from ``key``: logu, eps0, rs (rounds, ...)."""
    k_u, k_eps, k_loop = jax.random.split(key, 3)

    def shrink(k, _):
        k, k_r = jax.random.split(k)
        return k, jax.random.uniform(k_r, shape, dtype=_F64)

    return (jnp.log(jax.random.uniform(k_u, shape, dtype=_F64)),
            jax.random.uniform(k_eps, shape, dtype=_F64, maxval=_TWO_PI),
            jax.lax.scan(shrink, k_loop, None, length=rounds)[1])


def _theta_ess_draws(key, regime, H):
    """JAX's ``_draw_theta_ess`` numbers from ``key`` in the port's
    ThetaESSDraws layout, one chain's."""
    k_nu, k_ess = jax.random.split(key)
    z = jax.random.normal(k_nu, (n, 1) if regime == "CST" else (n, H), _F64)
    lanes = (n * H,) if regime == "RDM" else (n,)
    logu, eps0, rs = _ess_loop(k_ess, lanes)
    shape = (n, H) if regime == "RDM" else (n,)
    return dict(z=z, logu=logu.reshape(shape), eps0=eps0.reshape(shape),
                rs=rs.reshape((-1,) + shape))


def _affine_draws(key, W=mw.AFFINE_W, R=mw.AFFINE_R):
    """``affine_theta_moves``' numbers from ``key``, one chain's."""
    k_shift, k_dil = jax.random.split(key)
    k_pick, k_acc = jax.random.split(k_shift)
    pairs = [jax.random.split(k) for k in jax.random.split(k_dil, R)]
    return dict(u_pick=jax.random.uniform(k_pick, (1, 2 * W + 1), _F64)[0],
                u_acc=jax.random.uniform(k_acc, (), _F64),
                ell=jnp.stack([jax.random.normal(kd, (), _F64) for kd, _ in pairs]),
                u_dil=jnp.stack([jax.random.uniform(ku, (), _F64) for _, ku in pairs]))


def _sweep_shard_draws(key, shard, jcfg, q, m_loc):
    """One sweep's numbers for item shard ``shard``, replayed from a chain's
    key as JAX's item-sharded conjugate branch consumes them: k_f, k_b and
    k_t fold in the shard; k_th and the affine moves' k_f_repl do not."""
    C, H = jcfg.C, jcfg.horizon
    k_f, _, k_th, k_b, k_t = jax.random.split(key, 5)
    k_aff = jax.random.fold_in(k_f, 1)
    k_f, k_b, k_t = (jax.random.fold_in(k, shard) for k in (k_f, k_b, k_t))
    k_u, k_e = jax.random.split(jax.random.fold_in(k_f, 2))
    k_q, k_p, k_n = jax.random.split(k_u, 3)
    k_nu, k_ess = jax.random.split(k_t)
    logu, eps0, rs = _ess_loop(k_ess, (H, m_loc))
    out = dict(u_z=jg._uniform2d(jax.random.fold_in(k_f, 0), (H, n, m_loc), _F64),
               z_q=jg._normal2d(k_q, (H, q, m_loc), _F64),
               z_p=jg._normal2d(k_p, (H, 3, m_loc), _F64),
               z_n=jg._normal2d(k_n, (H, N, m_loc), _F64),
               eps_f=jg._normal2d(k_e, (H, n, m_loc), _F64),
               zeta=jax.random.normal(k_b, (H, m_loc, 3), _F64),
               nu=jax.random.normal(k_nu, (H, m_loc, C - 1), _F64),
               logu=logu, eps0=eps0, rs=rs)
    k_th = jax.random.fold_in(k_th, 0)
    if jcfg.theta_method == "ess":
        out.update({f"th_{k}": v for k, v in _theta_ess_draws(
            k_th, jcfg.theta_regime, H).items()})
    else:
        out["u_theta"] = jg._uniform2d(k_th, (n, N), _F64)
    if jcfg.affine_rounds or jcfg.affine_shift_max:
        out.update({f"a_{k}": v for k, v in _affine_draws(k_aff).items()})
    return out


def _rounds_second(name, a):
    """A vmapped chain-first array in the port's layout: the round axis of
    an ESS loop's rs and of the dilation rounds before the chains."""
    a = np.asarray(a)
    return np.moveaxis(a, 0, 1) if name.endswith(("rs", "ell", "u_dil")) else a


def _jax_theta_ess(jcfg, jconsts, y, jstate, tkeys):
    mu_star = jax.vmap(lambda b: jg.compute_mu_star(jconsts, b))(jstate.beta)

    def body(st, ms, yy, cc, ks):
        return jax.vmap(lambda s1, m1, k1: jg.draw_theta(k1, s1, m1, yy, cc, jcfg, None,
                                                         IAX))(st, ms, ks)

    fn = _sharded("ci22", body, (_state_specs(IAX, None), P(None, None, None, IAX),
                                 P(None, None, IAX), consts_mesh_specs(jconsts, IAX, None), P()),
                  P())
    return np.asarray(fn(jstate, mu_star, jnp.asarray(y), jconsts, tkeys))


def _jax_sweeps(jcfg, jconsts, y, keys, jstate):
    """Three sweeps of the K chains on 2 item shards under shard_map."""
    specs = _state_specs(IAX, None)

    def body(st, ks, yy, cc):
        return jax.vmap(lambda s1, k1: jg.gibbs_sweep(s1, k1, yy, cc, jcfg, None, None,
                                                      IAX))(st, ks)

    fn = _sharded("ci22", body, (specs, P(), P(None, None, IAX),
                                 consts_mesh_specs(jconsts, IAX, None)), (specs, P()))
    out = []
    for it in range(w.SWEEPS):
        ks = jax.vmap(lambda k: jax.random.fold_in(k, it))(keys)
        jstate, ll = fn(jstate, ks, jnp.asarray(y), jconsts)
        out.append(({f: np.asarray(getattr(jstate, f)) for f in jg.GPIRTState._fields},
                    np.asarray(ll)))
    return out


def _jax_affine(tag, jcfg, jconsts, f, keys):
    iax, rax = _axes(tag)
    fn = _sharded(tag, lambda i, z, b, c, ks: jax.vmap(
        lambda k, ii, zz, bb: jg.affine_theta_moves(k, ii, zz, bb, c, jcfg, None, iax,
                                                    rax))(ks, i, z, b),
        (P(None, None, rax), P(None, None, rax, iax), P(None, None, None, iax),
         consts_mesh_specs(jconsts, iax, rax), P()),
        (P(None, None, rax), P(None, None, None, iax)))
    idx, beta = fn(jnp.asarray(f["a_idx"]), jnp.asarray(f["a_z"]), jnp.asarray(f["a_beta"]),
                   jconsts, keys)
    return np.asarray(idx), np.asarray(beta)


def _jax_swap(tag, jconsts, y, jstate, temps, k_swap, phase):
    iax, rax = _axes(tag)
    specs = _state_specs(iax, rax)
    G, L = K // 2, 2

    def body(st, yy, cc, tt):
        ll_own = jt._lane_ll(st, tt, yy, cc, iax, rax)
        return jt._swap(st, ll_own, tt, k_swap, phase, G, L, yy, cc, None, iax, rax)

    fn = _sharded(tag, body, (specs, P(None, rax, iax), consts_mesh_specs(jconsts, iax, rax),
                              P()), (specs, P(), P()))
    st, ll, acc = fn(jstate, jnp.asarray(y), jconsts, temps)
    return np.asarray(st.theta_idx), np.asarray(st.beta), np.asarray(ll), np.asarray(acc)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs and JAX's numbers written for the ranks, the 4-rank world
    started on them in a thread, and JAX's sharded blocks run here
    meanwhile."""
    tmp = str(tmp_path_factory.mktemp("mesh_jax_world"))
    setups, files = {}, {}
    for case in mw.CASES:
        jcfg, jconsts, y, keys, jstate = _setup(case)
        f = {f"c_{k}": np.asarray(v) for k, v in vars(jconsts).items() if v is not None}
        f.update({f"s_{k}": np.asarray(getattr(jstate, k)) for k in jg.GPIRTState._fields})
        f["y"] = y
        tkeys = jax.random.split(jax.random.key(11), K)
        d = jax.vmap(lambda k: _theta_ess_draws(k, jcfg.theta_regime, jcfg.horizon))(tkeys)
        f.update({f"ess_{k}": _rounds_second(k, v) for k, v in d.items()})
        setups[case], files[case] = (jcfg, jconsts, y, keys, jstate, tkeys), f
    f = files["cst"]
    jcfg, jconsts, y, keys, jstate, _ = setups["cst"]
    q = jconsts.U_se.shape[1]
    sweep_setups = {}
    for label, (_, opts) in mw.SWEEP_OPTS.items():
        scfg = _setup("cst", **opts)
        sweep_setups[label] = scfg
        f.update({f"{label}_s_{k}": np.asarray(getattr(scfg[4], k))
                  for k in jg.GPIRTState._fields})
        draws = jax.jit(jax.vmap(lambda k, s: _sweep_shard_draws(k, s, scfg[0], q, m // 2),
                                 in_axes=(0, None)))
        for it in range(w.SWEEPS):
            ks = jax.vmap(lambda k: jax.random.fold_in(k, it))(keys)
            for shard in range(2):
                for name, a in draws(ks, shard).items():
                    f[f"{label}_it{it}_shard{shard}_{name}"] = _rounds_second(name, a)
    rng = np.random.default_rng(3)
    f["a_idx"] = rng.integers(20, N - 20, (K, 1, n))
    f["a_z"] = rng.normal(size=(K, 1, n, m))
    f["a_beta"] = 0.3 * rng.normal(size=(K, 1, 3, m))
    akeys = jax.random.split(jax.random.key(21), K)
    f.update({f"a_{k}": _rounds_second(k, v)
              for k, v in jax.vmap(_affine_draws)(akeys).items()})
    k_swap = jax.random.key(77)
    for phase in (0, 1):
        f[f"swap_u{phase}"] = np.asarray(jax.random.uniform(
            jax.random.fold_in(k_swap, phase), (K,), _F64))
    for case, fc in files.items():
        np.savez(os.path.join(tmp, f"mesh_{case}.npz"), **fc)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tdist.launch, mw.jax_mesh_world, WORLD, (tmp,), device="cpu",
                            timeout=600)
        want = {"affine_in": f["a_idx"]}
        for case, (c_cfg, c_consts, c_y, _, c_state, tkeys) in setups.items():
            ecfg = dataclasses.replace(c_cfg, theta_method="ess")
            want[f"theta_ess_{case}"] = _jax_theta_ess(ecfg, c_consts, c_y, c_state, tkeys)
        for label, scfg in sweep_setups.items():
            want[label] = _jax_sweeps(*scfg)
        acfg = sweep_setups["affine"][0]
        for tag in mw.AFFINE_MESHES:
            want[f"affine_{tag}"] = _jax_affine(tag, acfg, jconsts, f, akeys)
        temps = jnp.asarray(np.tile(mw.SWAP_TEMPS, K // 2), _F64)
        for tag in mw.SWAP_MESHES:
            for phase in (0, 1):
                want[f"swap_{tag}_{phase}"] = _jax_swap(tag, jconsts, y, jstate, temps,
                                                        k_swap, phase)
        assert ranks.result() == list(range(WORLD))
    ranks = [dict(np.load(os.path.join(tmp, f"meshjax_rank{r}.npz"))) for r in range(WORLD)]
    return want, ranks


def _block(a, z, tag, name):
    """Rank ``z``'s block of a JAX array on mesh ``tag``: its chains, and
    its items and respondents for a field that has them."""
    c, i, r = (int(v) for v in z[f"place_{tag}"])
    nc = {"ci22": 2, "cr22": 2}.get(tag, 1)
    ni = {"ci22": 2, "i14": 4, "ir22": 2}.get(tag, 1)
    nr = {"ir22": 2, "cr22": 2}.get(tag, 1)
    a = a[c * K // nc:(c + 1) * K // nc]
    item_dim = {"f": -1, "beta": -1, "fstar": -1, "thresholds": -2}.get(name)
    resp_dim = {"f": -2, "theta_idx": -1}.get(name)
    for dim, k, place in ((item_dim, ni, i), (resp_dim, nr, r)):
        if dim is not None:
            size = a.shape[dim] // k
            a = np.take(a, np.arange(place * size, (place + 1) * size), axis=dim)
    return a


@pytest.mark.parametrize("case", list(mw.CASES))
def test_theta_ess_on_item_shards_matches_jax(world, case):
    """The item-sharded ESS theta draw (CST, RDM and GP) on a 2 x 2 chains x
    items mesh against JAX's on 2 item shards, given JAX's numbers: theta
    indices exactly, the same on both item shards of a chain block."""
    want, ranks = world
    for z in ranks:
        np.testing.assert_array_equal(z[f"theta_ess_{case}"],
                                      _block(want[f"theta_ess_{case}"], z, "ci22", "theta"))


@pytest.mark.parametrize("label", list(mw.SWEEP_OPTS))
def test_item_sharded_sweeps_match_jax(world, label):
    """Three item-sharded sweeps with ESS theta, and three with the affine
    moves (W 3, 2 rounds), on the 2 x 2 mesh against JAX's item-sharded
    sweep: theta exactly, the rest to rtol 1e-8."""
    want, ranks = world
    for z in ranks:
        for it, (state, ll) in enumerate(want[label]):
            np.testing.assert_array_equal(z[f"{label}_it{it}_theta_idx"],
                                          _block(state["theta_idx"], z, "ci22", "theta"))
            for fld in ("f", "beta", "thresholds", "fstar"):
                np.testing.assert_allclose(z[f"{label}_it{it}_{fld}"],
                                           _block(state[fld], z, "ci22", fld),
                                           rtol=RTOL, atol=RTOL)
            np.testing.assert_allclose(z[f"{label}_it{it}_ll"], _block(ll, z, "ci22", "ll"),
                                       rtol=RTOL)


@pytest.mark.parametrize("tag", list(mw.AFFINE_MESHES))
def test_affine_moves_on_item_shards_match_jax(world, tag):
    """affine_theta_moves on 2 item shards (a 2 x 2 chains x items mesh), on
    4, and on 2 x 2 items x respondents, against JAX's with the same model
    axes: theta exactly, beta to rtol 1e-12; the moves move some chains."""
    want, ranks = world
    idx, beta = want[f"affine_{tag}"]
    for z in ranks:
        np.testing.assert_array_equal(z[f"affine_{tag}_idx"],
                                      _block(idx, z, tag, "theta_idx"))
        np.testing.assert_allclose(z[f"affine_{tag}_beta"], _block(beta, z, tag, "beta"),
                                   rtol=1e-12, atol=1e-12)
    assert (idx != want["affine_in"]).any(axis=(1, 2)).sum() >= 2


@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("tag", list(mw.SWAP_MESHES))
def test_swap_phase_on_model_axes_matches_jax(world, tag, phase):
    """One swap phase on 2 item shards, 2 respondent shards and a 2 x 2
    items x respondents mesh against JAX's ``_swap`` with those model axes
    (the cross-temperature ll summed over them), JAX's uniforms: the accept
    decisions equal, the post-swap ll to rtol 1e-10, the swapped states'
    blocks equal. The ladder (1, 1.1) is close enough that phase 0 takes a
    swap; phase 1 has no pair at L = 2."""
    want, ranks = world
    w_idx, w_beta, w_ll, w_acc = want[f"swap_{tag}_{phase}"]
    assert w_acc.any() == (phase == 0)
    for z in ranks:
        pre = f"swap_{tag}_{phase}"
        np.testing.assert_array_equal(z[f"{pre}_acc"], _block(w_acc, z, tag, "acc"))
        np.testing.assert_allclose(z[f"{pre}_ll"], _block(w_ll, z, tag, "ll"), rtol=1e-10)
        np.testing.assert_array_equal(z[f"{pre}_theta_idx"],
                                      _block(w_idx, z, tag, "theta_idx"))
        np.testing.assert_array_equal(z[f"{pre}_beta"], _block(w_beta, z, tag, "beta"))


def test_tempered_run_on_items_by_respondents_is_replicated(world):
    """A tempered run on the 2 x 2 items x respondents mesh: theta alike on
    the item shards of a respondent block, beta, the cutpoints and f*
    alike on the respondent shards of an item block, and the swap tally and
    the gathered draws alike on every rank."""
    _, ranks = world
    by_place = {tuple(z["blk_ir22_place"]): z for z in ranks}
    for (c, i, r), z in by_place.items():
        np.testing.assert_array_equal(z["blk_ir22_theta_idx"],
                                      by_place[(c, 1 - i, r)]["blk_ir22_theta_idx"])
        for fld in ("beta", "thresholds", "fstar"):
            np.testing.assert_array_equal(z[f"blk_ir22_{fld}"],
                                          by_place[(c, i, 1 - r)][f"blk_ir22_{fld}"])
    for z in ranks[1:]:
        np.testing.assert_array_equal(z["blk_ir22_acc"], ranks[0]["blk_ir22_acc"])
        for k in ("theta", "beta", "threshold", "ll"):
            np.testing.assert_array_equal(z[f"blk_ir22_draws_{k}"], ranks[0][f"blk_ir22_draws_{k}"])
    assert ranks[0]["blk_ir22_draws_theta"].shape == (K, 6, 1, n)


def test_tempered_run_on_items_by_respondents_equals_unsharded_fed_its_numbers(world):
    """The tempered driver at L = 4 on the 2 x 2 items x respondents mesh,
    fed the unsharded run's numbers cut to each rank's items and
    respondents, against the port's unsharded driver from the same state
    and generator, over 6 sweeps each with a swap phase: the swap tally
    and theta exactly, the cold draws and each rank's block of the state
    within 1e-10."""
    _, ranks = world
    for z in ranks:
        mw.check_fed_case(z, "ir22")
