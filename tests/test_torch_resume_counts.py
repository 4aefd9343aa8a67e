"""A checkpoint resumed across counts of item and respondent shards
(``utils/checkpoint.py``'s stream rule), in float64 on the CPU.

Every case cuts a run on one layout (2 item shards, 2 respondent shards,
2 x 2 items x respondents, or none) after CUT draws and resumes it on
another; a tempered run on 2 item shards resumes without a mesh. The
mesh layouts run in one world of 4 Gloo ranks
(``_torch_resume_worker.resume_world``), the layouts without a mesh here,
before it (the cuts it resumes) and after it (the resumes of its cuts).
The JAX package resumes across meshes with draws that change
(``tests/test_checkpoint.py:323-345``); the port's draws change too, by a
rule that is checked here bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
import _torch_resume_worker as rw
from gpirt_tpu_torch.parallel import distributed as tdist
from gpirt_tpu_torch.parallel.chains import Shards
from gpirt_tpu_torch.parallel.respondents import resume_shard_generators, shard_generators
from gpirt_tpu_torch.utils.checkpoint import CheckpointManager


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """{case: {"a", "b", "c", "fed": host draws}, "file": the cut file's
    draws}: the cuts without a mesh, the world, then the resumes without
    one."""
    tmp = str(tmp_path_factory.mktemp("resume_counts"))
    for case, (src, _, _) in rw.CASES.items():
        if src == "none":
            rw.cut(case, tmp)
    assert tdist.launch(rw.resume_world, rw.WORLD, (tmp,), device="cpu",
                        timeout=600) == list(range(rw.WORLD))
    out = {}
    for case, (_, dst, _) in rw.CASES.items():
        if dst == "none":
            res = rw.resume(case, tmp)
        else:
            z = np.load(os.path.join(tmp, f"{case}_resumed.npz"))
            res = {tag: {k[len(tag) + 1:]: z[k] for k in z.files if k.startswith(tag + "_")}
                   for tag in ("a", "b", "c", "fed")}
        res["file"] = CheckpointManager(os.path.join(tmp, f"{case}_file.npz")).load().draws
        out[case] = res
    z = np.load(os.path.join(tmp, "chunked.npz"))
    out["chunked"] = {v: {k[len(v) + 1:]: z[k] for k in z.files if k.startswith(v + "_")}
                      for v in ("True", "False")}
    return out


@pytest.mark.parametrize("case", list(rw.CASES))
def test_resume_across_counts(resumed, case):
    """Cut on the first layout, resumed on the second: the draws saved
    before the cut are the file's bit for bit; the rest are the second
    layout's driver run by hand from the file's state, its replicated
    generator state and the rule's shard generators, bit for bit; two
    resumes of one file are equal; and a resume cut again on the new
    layout and resumed there equals the uninterrupted resume (the new
    file holds the new layout's shard states)."""
    r = resumed[case]
    a = r["a"]
    assert set(a) == {"theta", "beta", "threshold", "ll"}
    for k, v in a.items():
        assert v.shape[:2] == (rw.K, rw.DRAWS) and np.isfinite(v[..., 1:-1]).all()
        np.testing.assert_array_equal(v[:, :rw.CUT], r["file"][k])
        np.testing.assert_array_equal(v[:, rw.CUT:], r["fed"][k])
        np.testing.assert_array_equal(v, r["b"][k])
        np.testing.assert_array_equal(v, r["c"][k])


def test_resumed_shard_streams_are_fresh():
    """On 2 and 4 item shards, 2 respondent shards and 2 x 2 cells, the
    rule's shard generators at two sweep counts draw numbers apart from
    every fresh run's shard generators (a shard seeded (SEED, shard) again
    would replay the numbers its namesake drew) and from each other: no
    stream of a layout replays another's. The rule is a pure function of
    (seed, shard, count, sweep)."""
    def head(g):
        return tuple(torch.rand(4, generator=g, dtype=torch.float64).tolist())

    def streams(sg, sh, tag):
        """A place's distinct generators by role and shard (a generator an
        item shard's cells share counts once)."""
        if sg is None:
            return {}
        roles = {("item", sh.item_rank): sg.item, ("resp", sh.resp_rank): sg.resp}
        if all(sg.cell is not g for g in (sg.item, sg.resp)):
            roles[("cell", sh.item_rank, sh.resp_rank)] = sg.cell
        return {key + tag: head(g) for key, g in roles.items() if g is not None}

    layouts = ((2, 1), (4, 1), (1, 2), (2, 2))
    places = [Shards(n_item=ni, item_rank=i, n_resp=nr, resp_rank=j)
              for ni, nr in layouts for i in range(ni) for j in range(nr)]
    fresh = set()
    for sh in places:
        fresh |= set(streams(shard_generators(rw.SEED, sh, "cpu"), sh, ()).values())
    for ni, nr in layouts:
        rule = {}
        for sh in places:
            if (sh.n_item, sh.n_resp) == (ni, nr):
                for it in (4, 6):
                    rule.update(streams(resume_shard_generators(rw.SEED, sh, it, "cpu"),
                                        sh, (it,)))
        assert len(set(rule.values())) == len(rule) and not set(rule.values()) & fresh
    one, two = (resume_shard_generators(rw.SEED, Shards(n_item=2, item_rank=1), 4, "cpu")
                for _ in range(2))
    assert head(one.item) == head(two.item)


def test_verbose_mesh_run_chunks_alike_on_every_rank(resumed):
    """A verbose gpirt_mcmc on 2 item shards advances in chunks of
    ``chunk_iterations`` (3 of its 8 sweeps) on every rank, its progress
    printed on rank 0 alone: the ranks meet at each chunk's collectives,
    and the draws are the quiet call's bit for bit."""
    chunked = resumed["chunked"]
    for k, v in chunked["False"].items():
        np.testing.assert_array_equal(chunked["True"][k], v)
