"""What the ranks of the port's multi-process tests run
(``test_torch_items.py``, ``test_torch_respondents.py``,
``test_torch_distributed.py``), in a module that
imports no JAX, as ``_multihost_worker.py`` is for the JAX package: a
spawned rank imports the module that holds its function, and the test files
import JAX. Inputs and outputs cross as ``.npz`` files in the test's
directory; each rank writes ``<world>_rank<r>.npz``.

Sizes: n 12 respondents, m 8 items, K 4 chains, a 61-point grid, float64.
"""

import dataclasses
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from gpirt_tpu_torch import gpirt_campaigns, gpirt_mcmc
from gpirt_tpu_torch.api import default_thresholds
from gpirt_tpu_torch.convert import constants_from_numpy, state_from_numpy
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants, make_constants
from gpirt_tpu_torch.models.sampler import run_chains
from gpirt_tpu_torch.parallel.chains import (
    assemble_lane_state,
    lane_state_block,
    make_campaign_mesh,
    make_chain_mesh,
    shards_of,
)
from gpirt_tpu_torch.parallel.distributed import (
    _local_shard_bounds,
    global_chain_mesh,
    pooled_ess_multihost,
    run_chains_multihost,
)
from gpirt_tpu_torch.parallel.items import (
    consts_item_block,
    draws_item_block,
    make_item_mesh,
    run_chains_itemsharded,
)
from gpirt_tpu_torch.parallel.respondents import (
    consts_respondent_block,
    draws_respondent_block,
    make_respondent_mesh,
    run_chains_respondentsharded,
)
from gpirt_tpu_torch.parallel.smc import lane_block

n, m, K, N = 12, 8, 4, 61
F64 = torch.float64
# sweep cases: (C, H, theta_ls); CST at H = 1, GP at H = 3
SWEEP_CASES = {"C2": (2, 1, 10.0), "C5": (5, 1, 10.0), "gp_H3": (2, 3, 2.0)}
# draw_theta cases: (item shards, the sweep case whose data it reads)
THETA_CASES = {"items2": (2, "C2"), "items4": (4, "C2"), "gp_items2": (2, "gp_H3")}
SWEEPS = 3
LATENT = ("u_theta", "u_z", "z_q", "z_p", "z_n", "eps_f", "zeta")
CUT = ("nu", "logu", "eps0", "rs")
# the refusals the items world checks: (case, exception it must raise, or
# None where the case now runs and its gathered draws are checked)
REFUSALS = {"uneven_m": "ValueError", "chains_indivisible": "ValueError",
            "non_conjugate": "NotImplementedError", "theta_ess": "NotImplementedError",
            "affine": None, "n_temps": "ValueError",
            "respondent_axis": "ValueError", "campaign_mesh": "ValueError",
            "resume_other_item_count": None, "resume_without_mesh": None,
            "item_axis_not_named": "ValueError"}
RUN = dict(sample_iterations=6, burn_iterations=2)
# sweep families beside the conjugate one that the chains world runs on its
# chain mesh: GPIRTConfig fields
CHAIN_FAMILIES = {"two_stage": dict(f_method="two_stage")}


def port_config(case: str) -> GPIRTConfig:
    C, H, ls = SWEEP_CASES[case]
    return GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                       theta_ls=ls)


def votes(seed=0, n=n, m=m) -> np.ndarray:
    """(n, m) binary responses coded 1, 2 from a 2PL model, a few missing."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(-1.5, 1.5, n)
    p = 1 / (1 + np.exp(-np.outer(theta, rng.standard_normal(m) * 1.5)))
    y = np.where(rng.random((n, m)) < p, 2.0, 1.0)
    y[rng.random((n, m)) < 0.1] = np.nan
    return y


def chain_setup(K=K, **fields):
    """A small binary problem for run_chains: y, theta_init (K, 1, n),
    thresholds, constants and config (its further GPIRTConfig ``fields``:
    another sweep family)."""
    y = votes()
    yt = torch.as_tensor(np.nan_to_num(y, nan=0.0)[None].astype(np.int32))
    cfg = GPIRTConfig(n=n, m=m, horizon=1, C=2, grid_size=N, dtype="float64", **fields)
    consts = make_constants(cfg, np.zeros((3, m)), np.full((3, m), 3.0), np.zeros((2, n)),
                            np.full((2, n), 0.5), device="cpu")
    ti = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (K, 1, n)))
    return yt, ti, torch.as_tensor(default_thresholds(2, m, 1)), consts, cfg


def _consts(z) -> GPIRTConstants:
    return constants_from_numpy(
        {f.name: z[f"c_{f.name}"] if f"c_{f.name}" in z.files else None
         for f in dataclasses.fields(GPIRTConstants)}, device="cpu", dtype=F64)


def _state(z, prefix="s_"):
    return state_from_numpy({f: z[prefix + f] for f in tg.GPIRTState._fields},
                            device="cpu", dtype=F64)


def _block_inputs(z, case, shards):
    """This rank's block of a case's state, y, constants and config."""
    cfg = port_config(case)
    items = shards.items(m)
    consts = _consts(z)
    state = lane_state_block(_state(z), shards)
    y = torch.as_tensor(z["y"])[..., items].contiguous()
    return (state, y, consts_item_block(consts, items),
            dataclasses.replace(cfg, m=items.stop - items.start), consts, cfg)


def _theta_case(tmp, case, mesh, out):
    S, data = THETA_CASES[case]
    z = np.load(os.path.join(tmp, f"sweep_{data}.npz"))
    sh = shards_of(mesh, "items")
    state, y, cb, cl, _, _ = _block_inputs(z, data, sh)
    u = torch.as_tensor(z["theta_u"])[sh.chains(K)]
    mu_star = tg.compute_mu_star(cb, state.beta)
    out[f"theta_{case}"] = tg.draw_theta(state, mu_star, y, cb, cl, u, None,
                                         sh.item_group).numpy()


def _sweep_case(tmp, case, mesh, out):
    """Three item-sharded sweeps fed JAX's per-shard draws."""
    z = np.load(os.path.join(tmp, f"sweep_{case}.npz"))
    sh = shards_of(mesh, "items")
    state, y, cb, cl, _, _ = _block_inputs(z, case, sh)
    for it in range(SWEEPS):
        d = {k: torch.as_tensor(z[f"it{it}_shard{sh.item_rank}_{k}"]) for k in LATENT + CUT}
        draws = tg.SweepDraws(*(d[k] for k in LATENT), tg.ESSDraws(*(d[k] for k in CUT)))
        state, ll = tg.gibbs_sweep(state, lane_block(draws, sh.chains(K)), y, cb, cl,
                                   None, it, sh.item_group)
        for f in tg.GPIRTState._fields:
            out[f"{case}_it{it}_{f}"] = getattr(state, f).numpy()
        out[f"{case}_it{it}_ll"] = ll.numpy()


def _self_case(tmp, case, mesh, out):
    """One item-sharded sweep against the port's own unsharded sweep from
    the same state and the same full draws, cut to the block."""
    z = np.load(os.path.join(tmp, f"sweep_{case}.npz"))
    sh = shards_of(mesh, "items")
    state, y, cb, cl, consts, cfg = _block_inputs(z, case, sh)
    gen = torch.Generator().manual_seed(5)
    full = tg.sweep_draws(gen, K, consts, cfg)
    ref, ref_ll = tg.gibbs_sweep(_state(z), full, torch.as_tensor(z["y"]), consts, cfg)
    ref = lane_state_block(ref, sh)
    block = draws_item_block(lane_block(full, sh.chains(K)), sh.items(m))
    got, ll = tg.gibbs_sweep(state, block, y, cb, cl, None, 0, sh.item_group)
    for f in tg.GPIRTState._fields:
        out[f"self_{case}_{f}"] = getattr(got, f).numpy()
        out[f"selfref_{case}_{f}"] = getattr(ref, f).numpy()
    out[f"self_{case}_ll"] = ll.numpy()
    out[f"selfref_{case}_ll"] = ref_ll[sh.chains(K)].numpy()


def _mcmc(mesh, data=None, **kw):
    data = votes() if data is None else data
    args = dict(CHAIN=K, vote_codes=None, dtype="float64", device="cpu", verbose=False,
                grid_size=N, mesh=mesh, item_axis="items", **RUN)
    args.update(kw)
    return gpirt_mcmc(data, args.pop("sample_iterations"), args.pop("burn_iterations"),
                      **args)


def _chains_out(res, prefix, out):
    for k in ("theta", "beta", "threshold", "ll"):
        out[f"{prefix}_{k}"] = np.stack([d[k] for d in res])


def _refusal(fn):
    try:
        fn()
    except Exception as exc:  # the test names the type each case must raise
        return f"{type(exc).__name__}: {exc}"
    return "no error"


def _runs(prefix, out, fn):
    """A case that runs: ``fn()``'s draws saved under ``prefix``."""
    def run():
        for k, v in fn().items():
            out[f"{prefix}_{k}"] = v.numpy()
    return run


def _resumed(prefix, out, fn):
    """A resume that runs (a gpirt_mcmc call): its chains' draws saved
    under ``prefix`` as :func:`_runs` saves a driver's."""
    def run():
        _chains_out(fn(), prefix, out)
    return run


def _resume_alone(cut, path):
    """``cut(path)``, a checkpointed gpirt_mcmc call on a mesh cut short,
    then the same call without a mesh on every rank, each resuming a copy
    of the file of its own."""
    cut(path)
    own = f"{path}_rank{dist.get_rank()}"
    shutil.copy(path + ".npz", own + ".npz")
    return _mcmc(None, item_axis=None, checkpoint_path=own)


def check_runs(ranks, prefix, shape):
    """A case that runs (:func:`_runs`) on every rank: no error, the
    gathered draws the same on every rank, finite, theta of ``shape``."""
    z0 = ranks[0]
    for z in ranks:
        assert str(z[f"refusal_{prefix}"]) == "no error", str(z[f"refusal_{prefix}"])
        for k in ("theta", "beta", "threshold", "ll"):
            np.testing.assert_array_equal(z[f"run_{prefix}_{k}"], z0[f"run_{prefix}_{k}"])
    assert z0[f"run_{prefix}_theta"].shape == shape
    assert np.isfinite(z0[f"run_{prefix}_ll"]).all()


def items_world(tmp):
    """The items world (4 ranks): draw_theta on a 2 x 2 and a 1 x 4 mesh,
    three sweeps of each case against JAX's and one against the port's
    own unsharded sweep, gpirt_mcmc with SMC on the 2 x 2 mesh, a
    checkpointed run interrupted and resumed there, and the refusals."""
    rank = dist.get_rank()
    mesh22 = make_item_mesh(2, 2, device="cpu")
    mesh14 = make_item_mesh(4, 1, device="cpu")
    out = {"names": np.array(mesh22.mesh_dim_names), "shape22": np.array(mesh22.shape)}
    for mesh, tag in ((mesh22, "22"), (mesh14, "14")):
        sh = shards_of(mesh, "items")
        out[f"place{tag}"] = np.array([sh.chain_rank, sh.item_rank])
    for case, (S, _) in THETA_CASES.items():
        _theta_case(tmp, case, mesh22 if S == 2 else mesh14, out)
    for case in SWEEP_CASES:
        _sweep_case(tmp, case, mesh22, out)
        _self_case(tmp, case, mesh22, out)
    _chains_out(_mcmc(mesh22, smc_steps=6, smc_max_temp=8.0), "mcmc", out)

    ck = os.path.join(tmp, "items_ck")
    ck_kw = dict(checkpoint_every=3, checkpoint_path=ck)
    _chains_out(_mcmc(mesh22, checkpoint_path=os.path.join(tmp, "items_full"),
                      checkpoint_every=3), "ck_full", out)
    _mcmc(mesh22, sample_iterations=2, **ck_kw)
    _chains_out(_mcmc(mesh22, **ck_kw), "ck_resumed", out)

    yt, ti, thr, consts, cfg = chain_setup()
    cut_path = os.path.join(tmp, "items_cut")
    refusals = {
        "uneven_m": lambda: _mcmc(mesh14, data=votes(n=n, m=6)),
        "chains_indivisible": lambda: _mcmc(mesh22, CHAIN=3),
        "non_conjugate": lambda: _mcmc(mesh22, f_method="two_stage"),
        "theta_ess": lambda: _mcmc(mesh22, theta_method="ess", n_temps=2),
        "affine": _runs("run_affine", out, lambda: run_chains_itemsharded(
            torch.Generator().manual_seed(0), yt, ti, thr, consts,
            dataclasses.replace(cfg, affine_rounds=1), mesh=mesh22, **RUN)),
        "n_temps": lambda: _mcmc(mesh22, n_temps=2, CHAIN=3),
        "respondent_axis": lambda: _mcmc(mesh22, respondent_axis="respondents"),
        "campaign_mesh": lambda: gpirt_campaigns(votes(), 2, vote_codes=None, device="cpu",
                                                 mesh=make_campaign_mesh(device="cpu")),
        "resume_other_item_count": _resumed("run_resume_other_item_count", out, lambda: (
            _mcmc(mesh22, sample_iterations=2, checkpoint_path=cut_path),
            _mcmc(mesh14, checkpoint_path=cut_path))[1]),
        "resume_without_mesh": _resumed("run_resume_without_mesh", out, lambda: _resume_alone(
            lambda p: _mcmc(mesh22, sample_iterations=2, checkpoint_path=p),
            cut_path + "_alone")),
        "item_axis_not_named": lambda: _mcmc(mesh22, item_axis=None),
    }
    for name, fn in refusals.items():
        out[f"refusal_{name}"] = np.array(_refusal(fn))
    np.savez(os.path.join(tmp, f"items_rank{rank}.npz"), **out)
    return rank


def chains_world(tmp):
    """The chains world (2 ranks): run_chains (the conjugate sweep and each
    of CHAIN_FAMILIES), gpirt_mcmc with SMC, and
    run_chains_multihost on a chain mesh, the pooled ESS of the ranks'
    blocks, a state's blocks reassembled, and checkpoints across meshes
    (interrupted here and resumed by the test without a mesh, and the
    test's unsharded interrupted run resumed here)."""
    rank = dist.get_rank()
    mesh = make_chain_mesh(device="cpu")
    out = {"names": np.array(mesh.mesh_dim_names), "world": np.array(dist.get_world_size()),
           "global_names": np.array(global_chain_mesh(device="cpu").mesh_dim_names),
           "bounds": np.array(_local_shard_bounds(mesh, K))}
    yt, ti, thr, consts, cfg = chain_setup()
    gen = torch.Generator().manual_seed(3)
    rc = run_chains(gen, yt, ti, thr, consts, cfg, mesh=mesh, **RUN)
    for k, v in rc.items():
        out[f"rc_{k}"] = v.numpy()
    for name, fields in CHAIN_FAMILIES.items():  # the non-conjugate sweep families
        rc = run_chains(torch.Generator().manual_seed(3), *chain_setup(**fields), mesh=mesh,
                        **RUN)
        for k, v in rc.items():
            out[f"rc_{name}_{k}"] = v.numpy()
    _chains_out(_mcmc(mesh, item_axis=None, smc_steps=6, smc_max_temp=8.0), "mcmc", out)
    mh = run_chains_multihost(5, K, yt, ti[0], thr, consts, cfg, mesh=mesh, **RUN)
    out["multihost_theta"] = mh["theta"].numpy()
    draws = torch.as_tensor(np.random.default_rng(2).standard_normal((K, 40, 5)))
    out["pooled_ess"] = pooled_ess_multihost(draws[shards_of(mesh).chains(K)], mesh).numpy()
    state = tg.init_state(ti, thr, consts, cfg, tg.init_draws(gen, K, consts, cfg))
    back = assemble_lane_state(lane_state_block(state, mesh), mesh)
    out["roundtrip"] = np.array(all(torch.equal(a, b) for a, b in zip(state, back)))
    ck = dict(checkpoint_every=3, smc_steps=6, smc_max_temp=8.0, item_axis=None)
    _mcmc(mesh, sample_iterations=2, checkpoint_path=os.path.join(tmp, "mesh_cut"), **ck)
    _chains_out(_mcmc(mesh, checkpoint_path=os.path.join(tmp, "plain_cut"), **ck),
                "resumed_on_mesh", out)
    np.savez(os.path.join(tmp, f"chains_rank{rank}.npz"), **out)
    return rank


def fail_on_rank_one():
    """A rank that raises: the launcher must raise in the parent."""
    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return dist.get_rank()


def sleep_past_the_timeout(seconds):
    import time

    time.sleep(seconds)
    return dist.get_rank()


def card_config() -> GPIRTConfig:
    """The card test's sharded sweep: 4 chains, 12 x 8, float32."""
    return GPIRTConfig(n=n, m=m, horizon=1, C=2, grid_size=N, dtype="float32", jitter=1e-5)


def card_sharded_sweep(path, out_dir, seed=3):
    """One sweep on this rank's item block of the card, from the state and
    constants in ``path`` and the unsharded sweep's draws (seeded ``seed``
    on the card) cut to the block; the result saved in ``out_dir``."""
    from gpirt_tpu_torch.api import full_fp32_matmuls
    from gpirt_tpu_torch.models.config import GPIRTConstants as Consts

    full_fp32_matmuls()
    dev = torch.device("cuda", torch.cuda.current_device())
    saved = torch.load(path, map_location=dev)
    state, consts = tg.GPIRTState(*saved["state"]), Consts(**saved["consts"])
    cfg, y = card_config(), saved["y"]
    draws = tg.sweep_draws(torch.Generator(device=dev).manual_seed(seed), K, consts, cfg)
    sh = shards_of(make_item_mesh(2, device="cuda"), "items")
    items = sh.items(m)
    got, ll = tg.gibbs_sweep(lane_state_block(state, sh, "items"),
                             draws_item_block(draws, items), y[..., items].contiguous(),
                             consts_item_block(consts, items),
                             dataclasses.replace(cfg, m=items.stop - items.start), None, 0,
                             sh.item_group)
    torch.save([a.cpu() for a in got] + [ll.cpu()],
               os.path.join(out_dir, f"card_rank{dist.get_rank()}.pt"))
    return dist.get_rank()


def card_respondent_sweep(path, out_dir, seed=3):
    """One sweep on this rank's respondent block of the card, from the state
    and constants in ``path`` and the unsharded sweep's draws (seeded
    ``seed`` on the card) cut to the block; the result saved in
    ``out_dir``."""
    from gpirt_tpu_torch.api import full_fp32_matmuls
    from gpirt_tpu_torch.models.config import GPIRTConstants as Consts

    full_fp32_matmuls()
    dev = torch.device("cuda", torch.cuda.current_device())
    saved = torch.load(path, map_location=dev)
    state, consts = tg.GPIRTState(*saved["state"]), Consts(**saved["consts"])
    cfg, y = card_config(), saved["y"]
    draws = tg.sweep_draws(torch.Generator(device=dev).manual_seed(seed), K, consts, cfg)
    sh = shards_of(make_respondent_mesh(2, device="cuda"), None, RESP)
    r = sh.respondents(n)
    got, ll = tg.gibbs_sweep(lane_state_block(state, sh), draws_respondent_block(draws, r, cfg),
                             y[:, r].contiguous(), consts_respondent_block(consts, r),
                             dataclasses.replace(cfg, n=r.stop - r.start), None, 0, None,
                             sh.resp_group)
    torch.save([a.cpu() for a in got] + [ll.cpu()],
               os.path.join(out_dir, f"card_resp_rank{dist.get_rank()}.pt"))
    return dist.get_rank()


def sleep_in_stage(seconds, stage_done):
    """Two stages: the first ends at once, the second sleeps ``seconds``."""
    import time

    stage_done()
    time.sleep(seconds)
    return dist.get_rank()


# ---------------------------------------------------------------------------
# the respondents world (test_torch_respondents.py)
# ---------------------------------------------------------------------------

RESP = "respondents"
# the refusals the respondents world checks: (case, exception it must raise)
RESP_REFUSALS = {"uneven_n": "ValueError", "non_conjugate": "NotImplementedError",
                 "n_temps": "ValueError", "affine_item_axis": None,
                 "resume_other_resp_count": None, "resume_without_mesh": None}
# sweeps against JAX's respondent-sharded sweep: (the sweep case whose state,
# data and draws it reads, one temperature a chain or None)
TEMPS = (1.0, 2.0, 4.0, 8.0)
RESP_SWEEP_CASES = {**{case: (case, None) for case in SWEEP_CASES},
                    "C2_tempered": ("C2", TEMPS), "C5_tempered": ("C5", TEMPS)}
# sharded sweeps against the port's own unsharded sweep: (sweep case, options)
RESP_SELF_CASES = {"C2": ("C2", {}), "C5": ("C5", {}), "gp_H3": ("gp_H3", {}),
                   "affine": ("C2", dict(affine_shift_max=2, affine_rounds=2)),
                   "theta_ess": ("C2", dict(theta_method="ess")),
                   "collapsed": ("C5", dict(threshold_method="collapsed")),
                   "newton": ("C2", dict(threshold_method="newton"))}


def _resp_block(z, sh, case, prefix="s_"):
    """This rank's respondent block of a case's state, y, constants and
    config (all chains, all items)."""
    cfg = port_config(case)
    r = sh.respondents(n)
    consts = _consts(z)
    state = lane_state_block(_state(z, prefix), sh)
    y = torch.as_tensor(z["y"])[:, r].contiguous()
    return (state, y, consts_respondent_block(consts, r),
            dataclasses.replace(cfg, n=r.stop - r.start), consts, cfg)


def _resp_blocks_case(tmp, sh, out):
    """Each coupled block on this rank's respondents, fed JAX's numbers."""
    z = np.load(os.path.join(tmp, "resp_blocks.npz"))
    g, r = sh.resp_group, sh.respondents(n)
    T = torch.as_tensor
    consts = _consts(z)
    cb = consts_respondent_block(consts, r)

    def rows(a, dim):
        return T(a).narrow(dim, r.start, r.stop - r.start).contiguous()

    from gpirt_tpu_torch.models import affine

    x, ld = affine.lowrank_bsolve(rows(z["lr_idx"], -1), cb, rows(z["lr_r"], -2),
                                  None, g)
    out["lowrank_x"], out["lowrank_logdet"] = x.numpy(), ld.numpy()
    for tag in ("session", "pooled"):
        cfg = port_config("C2" if tag == "session" else "gp_H3")
        cfg = dataclasses.replace(cfg, constant_IRF=tag == "pooled")
        cz = consts if tag == "session" else _consts(np.load(os.path.join(tmp,
                                                                          "sweep_gp_H3.npz")))
        cz = consts_respondent_block(cz, r)
        st = tg.GPIRTState(rows(z[f"fs_{tag}_idx"], -1), None, None, None, None)
        fs, f = tg.draw_fstar_conjugate(
            st, rows(z[f"fs_{tag}_zr"], -2), cfg, cz, T(z[f"fs_{tag}_z_q"]),
            T(z[f"fs_{tag}_z_p"]), T(z[f"fs_{tag}_z_n"]),
            T(z[f"fs_{tag}_eps_r{sh.resp_rank}"]), None, g)
        out[f"fstar_{tag}"], out[f"fstar_{tag}_f"] = fs.numpy(), f.numpy()
    cfg2 = port_config("C2")
    out["beta"] = tg.draw_beta_conjugate(rows(z["b_theta"], -1), rows(z["b_zmf"], -2), cb,
                                         cfg2, T(z["b_zeta"]), None, g).numpy()
    for C in (2, 4):
        cfg = dataclasses.replace(cfg2, C=C)
        f, mu, y = rows(z[f"t{C}_f"], -2), rows(z[f"t{C}_mu"], -2), rows(z[f"t{C}_y"], -2)
        thr = T(z[f"t{C}_thr"])
        out[f"ess_C{C}"] = tg.draw_threshold(
            thr, f, mu, y, cfg, *(T(z[f"t{C}_{k}"]) for k in CUT), None, g).numpy()
        newton = dataclasses.replace(cfg, threshold_method="newton")
        out[f"newton_C{C}"] = tg._draw_cutpoints(
            thr, f, mu, y, newton, tg.NewtonDraws(T(z[f"t{C}_nz"]), T(z[f"t{C}_nlogu"])),
            None, g).numpy()
    out["collapsed"] = tg.draw_threshold_collapsed(
        T(z["t2_thr"]), rows(z["c_z"], -2), rows(z["t2_y"], -2), cfg2,
        tg.CollapsedDraws(T(z["c_u"])), g).numpy()
    acfg = dataclasses.replace(cfg2, affine_shift_max=3, affine_rounds=4)
    draws = tg.AffineDraws(*(T(z[f"a_{k}"]) for k in ("u_pick", "u_acc", "ell", "u_dil")))
    idx, beta = affine.affine_theta_moves(rows(z["a_idx"], -1), rows(z["a_z"], -2),
                                          T(z["a_beta"]), cb, acfg, draws, None, g)
    out["affine_idx"], out["affine_beta"] = idx.numpy(), beta.numpy()


def _resp_sweep_case(tmp, label, sh, out):
    """Three respondent-sharded sweeps fed JAX's per-shard draws, at T = 1
    or one temperature a chain (RESP_SWEEP_CASES)."""
    case, temps = RESP_SWEEP_CASES[label]
    z = np.load(os.path.join(tmp, f"sweep_{case}.npz"))
    state, y, cb, cl, _, _ = _resp_block(z, sh, case)
    temp = None if temps is None else torch.tensor(temps, dtype=F64)
    for it in range(SWEEPS):
        d = {k: torch.as_tensor(z[f"resp_it{it}_shard{sh.resp_rank}_{k}"])
             for k in LATENT + CUT}
        draws = tg.SweepDraws(*(d[k] for k in LATENT), tg.ESSDraws(*(d[k] for k in CUT)))
        state, ll = tg.gibbs_sweep(state, draws, y, cb, cl, temp, it, None, sh.resp_group)
        for f in tg.GPIRTState._fields:
            out[f"{label}_it{it}_{f}"] = getattr(state, f).numpy()
        out[f"{label}_it{it}_ll"] = ll.numpy()


def _resp_self_case(tmp, label, sh, out):
    """One respondent-sharded sweep against the port's own unsharded sweep
    from the same state and the same full draws, cut to the block."""
    case, opts = RESP_SELF_CASES[label]
    z = np.load(os.path.join(tmp, f"sweep_{case}.npz"))
    state, y, cb, cl, consts, cfg = _resp_block(z, sh, case)
    cfg, cl = (dataclasses.replace(c, **opts) for c in (cfg, cl))
    full = tg.sweep_draws(torch.Generator().manual_seed(5), K, consts, cfg)
    ref, ref_ll = tg.gibbs_sweep(_state(z), full, torch.as_tensor(z["y"]), consts, cfg)
    ref = lane_state_block(ref, sh)
    block = draws_respondent_block(full, sh.respondents(n), cfg)
    got, ll = tg.gibbs_sweep(state, block, y, cb, cl, None, 0, None, sh.resp_group)
    for f in tg.GPIRTState._fields:
        out[f"self_{label}_{f}"] = getattr(got, f).numpy()
        out[f"selfref_{label}_{f}"] = getattr(ref, f).numpy()
    out[f"self_{label}_ll"] = ll.numpy()
    out[f"selfref_{label}_ll"] = ref_ll.numpy()


def _resp_anneal_case(mesh, tag, out, steps=6, max_temp=8.0, chains=8):
    """anneal_init on a respondent mesh fed the unsharded anneal's numbers
    (each sweep's drawn for all respondents from the replicated generator,
    as one process draws them, and cut to the rank's block), beside the
    port's unsharded anneal_init from the same seed: this rank's block of
    each."""
    from gpirt_tpu_torch.parallel import smc

    yt, ti, thr, consts, cfg = chain_setup(chains)
    sh = shards_of(mesh, None, RESP)
    r = sh.respondents(n)
    run = dict(n_steps=steps, max_temp=max_temp)
    ref, ref_info = smc.anneal_init(torch.Generator().manual_seed(9), yt, ti, thr, consts, cfg,
                                    **run)
    sweep_draws = smc.sweep_draws

    def unsharded_numbers(gen, K_, _consts, _cfg, iteration, _shard_gens):
        return draws_respondent_block(sweep_draws(gen, K_, consts, cfg, iteration), r, cfg)

    smc.sweep_draws = unsharded_numbers
    try:
        got, info = smc.anneal_init(torch.Generator().manual_seed(9), yt, ti, thr, consts, cfg,
                                    mesh=mesh, respondent_axis=RESP, **run)
    finally:
        smc.sweep_draws = sweep_draws
    for name, a, b in zip(tg.GPIRTState._fields, got, lane_state_block(ref, sh)):
        out[f"anneal_{tag}_{name}"], out[f"annealref_{tag}_{name}"] = a.numpy(), b.numpy()
    for k in ("weight_ess", "n_resamples", "final_weight_ess"):
        out[f"anneal_{tag}_{k}"] = np.asarray(info[k])
        out[f"annealref_{tag}_{k}"] = np.asarray(ref_info[k])


def respondents_world(tmp):
    """The respondents world (4 ranks): each coupled block and three sweeps
    of each case (two tempered) on a 4-shard respondent mesh against JAX's,
    sharded sweeps and anneal_init against the port's unsharded ones,
    gpirt_mcmc on a 4-shard respondent mesh with SMC, on a 2 x 2 chains x
    respondents mesh with SMC and on a 1 x 2 x 2 chains x items x
    respondents mesh, checkpointed runs cut and resumed on the 2 x 2
    meshes, and the refusals."""
    rank = dist.get_rank()
    resp4 = make_respondent_mesh(4, device="cpu")
    cr22 = make_respondent_mesh(2, n_chain_shards=2, device="cpu")
    ir22 = make_respondent_mesh(2, n_item_shards=2, device="cpu")
    out = {}
    for mesh, tag, axes in ((resp4, "r4", (None, RESP)), (cr22, "cr", (None, RESP)),
                            (ir22, "ir", ("items", RESP))):
        sh = shards_of(mesh, *axes)
        out[f"names_{tag}"] = np.array(mesh.mesh_dim_names)
        out[f"place_{tag}"] = np.array([sh.chain_rank, sh.item_rank, sh.resp_rank])
    sh = shards_of(resp4, None, RESP)
    _resp_blocks_case(tmp, sh, out)
    for label in RESP_SWEEP_CASES:
        _resp_sweep_case(tmp, label, sh, out)
    for label in RESP_SELF_CASES:
        _resp_self_case(tmp, label, sh, out)
    _resp_anneal_case(resp4, "r4", out)
    _resp_anneal_case(cr22, "cr", out)

    def mcmc(mesh, item_axis=None, **kw):
        return _mcmc(mesh, item_axis=item_axis, respondent_axis=RESP, **kw)

    smc = dict(smc_steps=6, smc_max_temp=8.0)
    _chains_out(mcmc(resp4, **smc), "mcmc_r4", out)
    _chains_out(mcmc(cr22, **smc), "mcmc_cr", out)
    res = mcmc(ir22, "items", store_f=True)
    _chains_out(res, "mcmc_ir", out)
    out["mcmc_ir_f"] = np.stack([d["f"] for d in res])
    for mesh, tag, axis in ((cr22, "cr", None), (ir22, "ir", "items")):
        ck = dict(checkpoint_every=3, checkpoint_path=os.path.join(tmp, f"resp_ck_{tag}"))
        _chains_out(mcmc(mesh, axis, checkpoint_path=os.path.join(tmp, f"resp_full_{tag}"),
                         checkpoint_every=3), f"ck_full_{tag}", out)
        mcmc(mesh, axis, sample_iterations=2, **ck)
        _chains_out(mcmc(mesh, axis, **ck), f"ck_resumed_{tag}", out)

    yt, ti, thr, consts, cfg = chain_setup()
    cut_path = os.path.join(tmp, "resp_cut")
    refusals = {
        "uneven_n": lambda: mcmc(resp4, data=votes(n=10)),
        "non_conjugate": lambda: mcmc(resp4, f_method="two_stage"),
        "n_temps": lambda: mcmc(cr22, n_temps=2, CHAIN=3),
        "affine_item_axis": _runs("run_affine_item_axis", out,
                                  lambda: run_chains_respondentsharded(
            torch.Generator().manual_seed(0), yt, ti, thr, consts,
            dataclasses.replace(cfg, affine_rounds=1), mesh=ir22, item_axis="items",
            **RUN)),
        "resume_other_resp_count": _resumed("run_resume_other_resp_count", out, lambda: (
            mcmc(cr22, sample_iterations=2, checkpoint_path=cut_path),
            mcmc(resp4, checkpoint_path=cut_path))[1]),
        "resume_without_mesh": _resumed("run_resume_without_mesh", out, lambda: _resume_alone(
            lambda p: mcmc(cr22, sample_iterations=2, checkpoint_path=p),
            cut_path + "_alone")),
    }
    for name, fn in refusals.items():
        out[f"refusal_{name}"] = np.array(_refusal(fn))
    np.savez(os.path.join(tmp, f"resp_rank{rank}.npz"), **out)
    return rank
