"""What the ranks of the mesh tests of ESS theta, the affine moves,
tempering and campaigns run (``test_torch_mesh_jax.py``,
``test_torch_mesh_tempering.py``), in a module that imports no JAX, as
``_torch_dist_worker.py`` is for the earlier mesh tests. Inputs and outputs
cross as ``.npz`` files in the test's directory; each rank writes
``<world>_rank<r>.npz``.

Sizes are ``_torch_dist_worker``'s: n 12 respondents, m 8 items, K 4
chains, a 61-point grid, float64.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

import _torch_dist_worker as w
from gpirt_tpu_torch import gpirt_campaigns
from gpirt_tpu_torch.models import affine
from gpirt_tpu_torch.models import gibbs as tg
from gpirt_tpu_torch.models.config import GPIRTConfig
from gpirt_tpu_torch.models.sampler import Carry, run_length, sample_schedule
from gpirt_tpu_torch.parallel import smc
from gpirt_tpu_torch.parallel import tempering as pt
from gpirt_tpu_torch.parallel.chains import (
    campaign_shards,
    lane_state_block,
    make_campaign_mesh,
    make_chain_mesh,
    shards_of,
)
from gpirt_tpu_torch.parallel.items import consts_item_block, draws_item_block, make_item_mesh
from gpirt_tpu_torch.parallel.respondents import (
    consts_respondent_block,
    draws_respondent_block,
    make_respondent_mesh,
)
from gpirt_tpu_torch.parallel.tempering import (
    _swap,
    advance_tempered,
    run_tempered_chains,
    tempered_start,
)
from gpirt_tpu_torch.utils.checkpoint import CheckpointManager, run_tempered_chains_checkpointed

n, m, K, N = w.n, w.m, w.K, w.N
RESP = "respondents"
# the data and state cases of the JAX comparison: (C, H, theta_ls); the
# theta regime follows from H and theta_ls (CST, RDM, GP)
CASES = {"cst": (2, 1, 10.0), "rdm": (2, 3, 0.05), "gp": (2, 3, 2.0)}
# the item-sharded sweeps against JAX's: (the case, its sampler options)
AFFINE_W, AFFINE_R = 3, 2
SWEEP_OPTS = {"theta_ess": ("cst", dict(theta_method="ess")),
              "affine": ("cst", dict(affine_shift_max=AFFINE_W, affine_rounds=AFFINE_R))}
# the meshes of the 4-rank world: (builder arguments, item axis, respondent axis)
MESHES = {"ci22": ("items", None), "i14": ("items", None), "ir22": ("items", RESP),
          "cr22": (None, RESP)}
# the affine moves on item shards (the mesh) and the swap phase on model axes
AFFINE_MESHES = ("ci22", "i14", "ir22")
SWAP_MESHES = ("ci22", "cr22", "ir22")
SWAP_TEMPS = (1.0, 1.1)  # the swap case's ladder: G = 2 groups of L = 2 lanes
TEMPERED = dict(sample_iterations=6, burn_iterations=2, n_temps=2, max_temp=2.0)


def case_config(case: str, **opts) -> GPIRTConfig:
    C, H, ls = CASES[case]
    return GPIRTConfig(n=n, m=m, horizon=H, C=C, grid_size=N, dtype="float64",
                       theta_ls=ls, **opts)


def _meshes():
    return {"ci22": make_item_mesh(2, 2, device="cpu"),
            "i14": make_item_mesh(4, 1, device="cpu"),
            "ir22": make_respondent_mesh(2, n_item_shards=2, device="cpu"),
            "cr22": make_respondent_mesh(2, n_chain_shards=2, device="cpu")}


def _shards(meshes, tag):
    return shards_of(meshes[tag], *MESHES[tag])


def _block(z, case, sh, prefix="s_", **opts):
    """This rank's block (chains, items, respondents) of a case's state, y,
    constants and config."""
    cfg = case_config(case, **opts)
    i, r = sh.items(m), sh.respondents(n)
    consts = w._consts(z)
    cb = consts_respondent_block(consts, r, i) if sh.n_resp > 1 else consts_item_block(consts, i)
    state = lane_state_block(w._state(z, prefix), sh)
    y = torch.as_tensor(z["y"])[:, r, i].contiguous()
    return state, y, cb, dataclasses.replace(cfg, n=r.stop - r.start, m=i.stop - i.start)


def _ess_draws(z, prefix, sh):
    """Theta's ESS draws, replicated, cut to this rank's chains."""
    T = torch.as_tensor
    d = tg.ThetaESSDraws(*(T(z[f"{prefix}_{k}"]) for k in ("z", "logu", "eps0", "rs")))
    return smc.lane_block(d, sh.chains(K))


def _theta_ess_case(tmp, case, sh, out):
    z = np.load(os.path.join(tmp, f"mesh_{case}.npz"))
    state, y, cb, cl = _block(z, case, sh, theta_method="ess")
    mu_star = tg.compute_mu_star(cb, state.beta)
    out[f"theta_ess_{case}"] = tg.draw_theta(state, mu_star, y, cb, cl,
                                             _ess_draws(z, "ess", sh), None,
                                             sh.item_group).numpy()


def _sweep_case(tmp, label, sh, out):
    """Three item-sharded sweeps fed JAX's per-shard draws."""
    case, opts = SWEEP_OPTS[label]
    z = np.load(os.path.join(tmp, f"mesh_{case}.npz"))
    state, y, cb, cl = _block(z, case, sh, f"{label}_s_", **opts)
    T = torch.as_tensor
    for it in range(w.SWEEPS):
        pre = f"{label}_it{it}_shard{sh.item_rank}"
        d = {k: T(z[f"{pre}_{k}"]) for k in w.LATENT + w.CUT if k != "u_theta"}
        u_theta = (tg.ThetaESSDraws(*(T(z[f"{pre}_th_{k}"]) for k in ("z", "logu", "eps0",
                                                                         "rs")))
                   if cl.theta_method == "ess" else T(z[f"{pre}_u_theta"]))
        aff = (tg.AffineDraws(*(T(z[f"{pre}_a_{k}"]) for k in ("u_pick", "u_acc", "ell",
                                                                 "u_dil")))
               if cl.affine else None)
        draws = tg.SweepDraws(u_theta, *(d[k] for k in w.LATENT[1:]),
                              tg.ESSDraws(*(d[k] for k in w.CUT)), affine=aff)
        state, ll = tg.gibbs_sweep(state, smc.lane_block(draws, sh.chains(K)), y, cb, cl,
                                   None, it, sh.item_group)
        for f in tg.GPIRTState._fields:
            out[f"{label}_it{it}_{f}"] = getattr(state, f).numpy()
        out[f"{label}_it{it}_ll"] = ll.numpy()


def _affine_case(tmp, tag, sh, out):
    """affine_theta_moves on this rank's block, JAX's draws (replicated)."""
    z = np.load(os.path.join(tmp, "mesh_cst.npz"))
    T = torch.as_tensor
    c, i, r = sh.chains(K), sh.items(m), sh.respondents(n)
    cfg = case_config("cst", affine_shift_max=AFFINE_W, affine_rounds=AFFINE_R)
    consts = w._consts(z)
    cb = consts_respondent_block(consts, r, i) if sh.n_resp > 1 else consts_item_block(consts, i)
    draws = smc.lane_block(tg.AffineDraws(*(T(z[f"a_{k}"]) for k in ("u_pick", "u_acc", "ell",
                                                                        "u_dil"))), c)
    idx, beta = affine.affine_theta_moves(
        T(z["a_idx"])[c][..., r].contiguous(), T(z["a_z"])[c][..., r, i].contiguous(),
        T(z["a_beta"])[c][..., i].contiguous(), cb, cfg, draws, None, sh.resp_group,
        sh.item_group)
    out[f"affine_{tag}_idx"], out[f"affine_{tag}_beta"] = idx.numpy(), beta.numpy()


def _swap_case(tmp, tag, sh, out):
    """One swap phase of each parity on this rank's block of the G = 2
    groups of L = 2 lanes, the cross-temperature ll summed over its model
    axes, JAX's uniforms."""
    z = np.load(os.path.join(tmp, "mesh_cst.npz"))
    state, y, cb, _ = _block(z, "cst", sh)
    c = sh.chains(K)
    temps = torch.as_tensor(np.tile(SWAP_TEMPS, K // 2))[c]
    groups = tuple(g for g in (sh.item_group, sh.resp_group) if g is not None)
    ll_own = smc._lane_ll(state, temps, y, cb)
    for g in groups:
        dist.all_reduce(ll_own, group=g)
    for phase in (0, 1):
        u = torch.as_tensor(z[f"swap_u{phase}"])[c]
        got, ll, acc = _swap(state, ll_own.clone(), temps, u, phase, 2, y, cb, groups)
        out[f"swap_{tag}_{phase}_acc"], out[f"swap_{tag}_{phase}_ll"] = acc.numpy(), ll.numpy()
        out[f"swap_{tag}_{phase}_theta_idx"] = got.theta_idx.numpy()
        out[f"swap_{tag}_{phase}_beta"] = got.beta.numpy()


def _tempered_blocks(sh, mesh, item_axis, respondent_axis, tag, out):
    """A tempered run's last state blocks and this rank's swap tally, on
    ``mesh``: the fields a model axis replicates must be alike on its
    shards."""
    yt, ti, thr, consts, cfg = w.chain_setup()
    gen = torch.Generator().manual_seed(6)
    st = tempered_start(gen, ti, thr, yt, consts, cfg, TEMPERED["n_temps"],
                        TEMPERED["max_temp"], mesh, item_axis, respondent_axis)
    carry = Carry(st.fresh())
    acc = torch.zeros(st.temps.shape[0], dtype=torch.int64)
    sched = sample_schedule(TEMPERED["sample_iterations"], TEMPERED["burn_iterations"], 1)
    acc, draws = advance_tempered(gen, carry, acc, st, TEMPERED["n_temps"], 1, sched, 0, 8)
    for f, a in carry.state._asdict().items():
        out[f"blk_{tag}_{f}"] = a.numpy()
    out[f"blk_{tag}_acc"] = acc.numpy()
    out[f"blk_{tag}_place"] = np.array([sh.chain_rank, sh.item_rank, sh.resp_rank])
    for k, v in draws.items():
        out[f"blk_{tag}_draws_{k}"] = v.numpy()


# the tempered driver fed the unsharded run's numbers: L lanes a group, the
# ladder's top, and the sweeps (burn, draws), a swap phase after each
FED = dict(n_temps=4, max_temp=2.0, burn=2, draws=4)


def _tempered_fed_case(mesh, item_axis, respondent_axis, tag, out):
    """The tempered driver (``advance_tempered``) on a model mesh fed the
    unsharded run's numbers (each sweep's drawn for all lanes, items and
    respondents from the one generator, as one process draws them, and cut
    to the rank's items and respondents), beside the port's unsharded
    driver from the same initial state and generator: the cold draws, the
    swap tally and the rank's block of the last state of each."""
    yt, ti, thr, consts, cfg = w.chain_setup()
    L, T = FED["n_temps"], FED["max_temp"]
    sched = sample_schedule(FED["draws"], FED["burn"], 1)
    stop = run_length(sched, trailing=False)
    ref_st = tempered_start(torch.Generator().manual_seed(6), ti, thr, yt, consts, cfg, L, T)
    init = ref_st.fresh()
    st = tempered_start(torch.Generator().manual_seed(6), ti, thr, yt, consts, cfg, L, T,
                        mesh, item_axis, respondent_axis)
    sh = st.shards
    carry = Carry(lane_state_block(init, sh))
    ref_carry = Carry(init)
    acc = torch.zeros(st.temps.shape[0], dtype=torch.int64)
    ref_acc, ref_draws = advance_tempered(torch.Generator().manual_seed(7), ref_carry,
                                          torch.zeros_like(acc), ref_st, L, 1, sched, 0, stop)
    sweep_draws = pt.sweep_draws

    def unsharded_numbers(gen, K_all, _consts, _cfg, iteration, _shard_gens):
        d = sweep_draws(gen, K_all, consts, cfg, iteration)
        if sh.n_item > 1:
            d = draws_item_block(d, sh.items(m))
        if sh.n_resp > 1:
            d = draws_respondent_block(d, sh.respondents(n), cfg)
        return d

    pt.sweep_draws = unsharded_numbers
    try:
        acc, draws = advance_tempered(torch.Generator().manual_seed(7), carry, acc, st, L, 1,
                                      sched, 0, stop)
    finally:
        pt.sweep_draws = sweep_draws
    ref_block = lane_state_block(ref_carry.state, sh)
    for f in tg.GPIRTState._fields:
        out[f"fed_{tag}_{f}"] = getattr(carry.state, f).numpy()
        out[f"fedref_{tag}_{f}"] = getattr(ref_block, f).numpy()
    out[f"fed_{tag}_acc"] = pt.gather_tally(acc, st).numpy()
    out[f"fedref_{tag}_acc"] = ref_acc.numpy()
    for k, v in draws.items():
        out[f"fed_{tag}_draws_{k}"] = v.numpy()
        out[f"fedref_{tag}_draws_{k}"] = ref_draws[k].numpy()


def check_fed_case(z, tag):
    """A rank's :func:`_tempered_fed_case` against its unsharded run: the
    swap tally exactly (at least one swap accepted), theta exactly, the
    cold draws and the rest of the state within 1e-10."""
    np.testing.assert_array_equal(z[f"fed_{tag}_acc"], z[f"fedref_{tag}_acc"])
    assert z[f"fedref_{tag}_acc"].sum() > 0
    np.testing.assert_array_equal(z[f"fed_{tag}_theta_idx"], z[f"fedref_{tag}_theta_idx"])
    for f in ("f", "beta", "thresholds", "fstar"):
        np.testing.assert_allclose(z[f"fed_{tag}_{f}"], z[f"fedref_{tag}_{f}"],
                                   rtol=1e-10, atol=1e-10)
    keys = [k[len(f"fedref_{tag}_draws_"):] for k in z if k.startswith(f"fedref_{tag}_draws_")]
    assert {"theta", "beta", "threshold", "ll"} <= set(keys)
    for k in keys:
        np.testing.assert_allclose(z[f"fed_{tag}_draws_{k}"], z[f"fedref_{tag}_draws_{k}"],
                                   rtol=1e-10, atol=1e-10)


def jax_mesh_world(tmp):
    """The 4-rank world of ``test_torch_mesh_jax.py``: ESS theta's draw on
    2 item shards in each regime, three item-sharded sweeps with ESS theta
    and with the affine moves, the affine moves on 2 and 4 item shards and
    on 2 x 2 items x respondents, one swap phase of each parity on item,
    respondent and 2 x 2 meshes (all fed JAX's numbers), and a tempered run
    on the 2 x 2 items x respondents mesh, on its own and fed the unsharded
    run's numbers."""
    torch.set_num_threads(1)  # tiny tensors: one thread a rank keeps a busy host free
    rank = dist.get_rank()
    meshes = _meshes()
    out = {}
    for tag in MESHES:
        sh = _shards(meshes, tag)
        out[f"place_{tag}"] = np.array([sh.chain_rank, sh.item_rank, sh.resp_rank])
    for case in CASES:
        _theta_ess_case(tmp, case, _shards(meshes, "ci22"), out)
    for label in SWEEP_OPTS:
        _sweep_case(tmp, label, _shards(meshes, "ci22"), out)
    for tag in AFFINE_MESHES:
        _affine_case(tmp, tag, _shards(meshes, tag), out)
    for tag in SWAP_MESHES:
        _swap_case(tmp, tag, _shards(meshes, tag), out)
    _tempered_blocks(_shards(meshes, "ir22"), meshes["ir22"], "items", RESP, "ir22", out)
    _tempered_fed_case(meshes["ir22"], "items", RESP, "ir22", out)
    np.savez(os.path.join(tmp, f"meshjax_rank{rank}.npz"), **out)
    return rank


# ---------------------------------------------------------------------------
# the 2-rank world (test_torch_mesh_tempering.py): the port against itself
# ---------------------------------------------------------------------------

CAMPAIGNS = dict(n_chains=4, smc_steps=4, smc_max_temp=8.0, burn_iterations=2,
                 sample_iterations=4, vote_codes=None, device="cpu", verbose=False,
                 grid_size=N, dtype="float64")
ANNEAL = dict(n_steps=5, max_temp=8.0)


def campaign_call(mesh=None, n_campaigns=2, **kw):
    return gpirt_campaigns(w.votes(), n_campaigns, mesh=mesh, **dict(CAMPAIGNS, **kw))


def anneal_gens(B=4):
    return [torch.Generator().manual_seed(11 + b) for b in range(B)]


def tempered_call(mesh=None, item_axis=None, respondent_axis=None, manager=None, **kw):
    yt, ti, thr, consts, cfg = w.chain_setup()
    run = dict(TEMPERED, **kw)
    if manager is None:
        return {k: v.numpy() for k, v in run_tempered_chains(
            torch.Generator().manual_seed(6), yt, ti, thr, consts, cfg, mesh=mesh,
            item_axis=item_axis, respondent_axis=respondent_axis, **run).items()}
    return run_tempered_chains_checkpointed(
        torch.Generator().manual_seed(6), yt, ti, thr, consts, cfg, mesh=mesh,
        item_axis=item_axis, respondent_axis=respondent_axis, manager=manager,
        checkpoint_every=3, **run)


def _save(prefix, draws, out):
    for k, v in draws.items():
        out[f"{prefix}_{k}"] = np.asarray(v)


def tempering_world(tmp):
    """The 2-rank world: a tempered run on a chain mesh, on 2 item shards
    and on 2 respondent shards, each state's replicated fields on its
    model shards, the tempered driver on both model meshes fed the
    unsharded run's numbers, checkpointed tempered runs cut and resumed on the chain
    and the item mesh (and onto another item count, which runs), gpirt_mcmc tempered
    on the item and the respondent mesh, ESS theta and the affine moves on
    2 item shards, the batched anneal and
    gpirt_campaigns on a campaign mesh, and the refusals of the new paths."""
    torch.set_num_threads(1)  # tiny tensors: one thread a rank keeps a busy host free
    rank = dist.get_rank()
    chain = make_chain_mesh(device="cpu")
    items = make_item_mesh(2, device="cpu")
    resp = make_respondent_mesh(2, device="cpu")
    camp = make_campaign_mesh(device="cpu")
    out = {"camp_names": np.array(camp.mesh_dim_names)}
    _save("pt_chain", tempered_call(chain), out)
    for tag, mesh, axes in (("items", items, ("items", None)), ("resp", resp, (None, RESP))):
        _save(f"pt_{tag}", tempered_call(mesh, *axes), out)
        _tempered_blocks(shards_of(mesh, *axes), mesh, *axes, tag, out)
        _tempered_fed_case(mesh, *axes, tag, out)

    for tag, mesh, axis in (("chain", chain, None), ("items", items, "items")):
        path = os.path.join(tmp, f"pt_ck_{tag}.npz")
        _save(f"ck_full_{tag}", tempered_call(mesh, axis, manager=CheckpointManager(
            os.path.join(tmp, f"pt_full_{tag}.npz"))), out)
        tempered_call(mesh, axis, manager=CheckpointManager(path), sample_iterations=2)
        _save(f"ck_resumed_{tag}", tempered_call(mesh, axis,
                                                 manager=CheckpointManager(path)), out)
    cut = os.path.join(tmp, "pt_cut_items.npz")
    tempered_call(items, "items", manager=CheckpointManager(cut), sample_iterations=2)

    def mcmc(mesh, **kw):
        return w._mcmc(mesh, n_temps=4, max_temp=4.0, **kw)

    w._chains_out(mcmc(items), "mcmc_items", out)
    w._chains_out(w._mcmc(items, theta_method="ess"), "mcmc_items_ess", out)
    yt, ti, thr, consts, cfg = w.chain_setup()
    _save("items_affine", w.run_chains_itemsharded(
        torch.Generator().manual_seed(0), yt, ti, thr, consts,
        dataclasses.replace(cfg, affine_shift_max=AFFINE_W, affine_rounds=AFFINE_R),
        mesh=items, **w.RUN), out)
    out["affine_orbit_accepted"] = np.asarray(affine.counts["orbit_accepted"])
    res = mcmc(resp, item_axis=None, respondent_axis=RESP)
    w._chains_out(res, "mcmc_resp", out)
    out["mcmc_resp_swap_rate"] = res[0]["swap_rate"]

    got, info = smc.anneal_init_batched(anneal_gens(), *w.chain_setup(), **ANNEAL,
                                        shards=campaign_shards(camp))
    _save("anneal", got._asdict(), out)
    _save("anneal_info", info, out)
    c = campaign_call(camp)
    for k in ("theta_mean", "theta_se", "campaign_means", "final_weight_ess", "n_resamples",
              "ess_campaign"):
        out[f"camp_{k}"] = np.asarray(c[k])
    _save("camp_draws", c["draws"], out)

    refusals = {
        "groups_indivisible": lambda: mcmc(chain, item_axis=None, CHAIN=3),
        "campaigns_indivisible": lambda: campaign_call(camp, n_campaigns=3),
        "theta_ess_tempered": lambda: mcmc(items, theta_method="ess"),
        "resume_other_item_count": lambda: _save("pt_other_count", tempered_call(
            make_item_mesh(1, 2, device="cpu"), "items", manager=CheckpointManager(cut)),
            out),
    }
    for name, fn in refusals.items():
        out[f"refusal_{name}"] = np.array(w._refusal(fn))
    np.savez(os.path.join(tmp, f"pt_rank{rank}.npz"), **out)
    return rank


# ---------------------------------------------------------------------------
# the card test of test_torch_gpu.py (no JAX on the card's machine)
# ---------------------------------------------------------------------------

CARD_OPTIONS = {"theta_ess": dict(theta_method="ess"),
                "affine": dict(affine_shift_max=AFFINE_W, affine_rounds=AFFINE_R)}


def card_option_config(label: str) -> GPIRTConfig:
    """The card test's item-sharded sweep: ``w.card_config()`` with ESS
    theta or the affine moves."""
    return dataclasses.replace(w.card_config(), **CARD_OPTIONS[label])


def card_option_sweep(path, out_dir, label, seed=3):
    """One sweep with ESS theta or the affine moves on this rank's item
    block of the card, from the state and constants in ``path`` and the
    unsharded sweep's draws (seeded ``seed`` on the card) cut to the block;
    the result saved in ``out_dir``."""
    from gpirt_tpu_torch.api import full_fp32_matmuls
    from gpirt_tpu_torch.models.config import GPIRTConstants
    from gpirt_tpu_torch.parallel.items import draws_item_block

    full_fp32_matmuls()
    dev = torch.device("cuda", torch.cuda.current_device())
    saved = torch.load(path, map_location=dev)
    state, consts = tg.GPIRTState(*saved["state"]), GPIRTConstants(**saved["consts"])
    cfg, y = card_option_config(label), saved["y"]
    draws = tg.sweep_draws(torch.Generator(device=dev).manual_seed(seed), K, consts, cfg)
    sh = shards_of(make_item_mesh(2, device="cuda"), "items")
    items = sh.items(m)
    got, ll = tg.gibbs_sweep(lane_state_block(state, sh, "items"),
                             draws_item_block(draws, items), y[..., items].contiguous(),
                             consts_item_block(consts, items),
                             dataclasses.replace(cfg, m=items.stop - items.start), None, 0,
                             sh.item_group)
    torch.save([a.cpu() for a in got] + [ll.cpu()],
               os.path.join(out_dir, f"card_{label}_rank{dist.get_rank()}.pt"))
    return dist.get_rank()
