"""The span recorder of ``gpirt_tpu_torch.utils.profiling`` on the CPU: off,
it hands back one shared object and records nothing; on (inside
``recording()`` or while a torch profiler records), every sweep of
``advance_chains`` records a ``sweep`` root holding its family's block
spans, on the clock of the profiler's events, and the sweeps it records
are the sweeps unrecorded, bit for bit.
"""

import time
import tracemalloc

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu_torch import _spans
from gpirt_tpu_torch.models.config import GPIRTConfig, make_constants
from gpirt_tpu_torch.models.sampler import Carry, advance_chains, chain_start, sample_schedule
from gpirt_tpu_torch.utils import profiling
from gpirt_tpu_torch.utils.profiling import clear_spans, recording, span, span_totals, spans

N_RESP, N_ITEMS, K = 12, 6, 3

# the block spans a sweep of each family opens inside its root
BLOCKS = {
    "conjugate": {"sweep.draws", "sweep.theta", "sweep.z", "sweep.fstar", "sweep.beta",
                  "sweep.cutpoints", "sweep.ll"},
    "grid": {"sweep.draws", "sweep.theta", "sweep.fstar", "sweep.beta", "sweep.cutpoints",
             "sweep.ll"},
    "two_stage": {"sweep.draws", "sweep.theta", "sweep.fstar", "sweep.beta",
                  "sweep.cutpoints", "sweep.ll"},
}


@pytest.fixture(autouse=True)
def _no_spans():
    clear_spans()
    yield
    clear_spans()


def _chains(f_method, seed=0):
    """(generator, carry, y, constants, config) of K chains at the prior
    init, float64 on the CPU."""
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(rng.integers(1, 3, size=(1, N_RESP, N_ITEMS)), dtype=torch.int32)
    cfg = GPIRTConfig(n=N_RESP, m=N_ITEMS, C=2, grid_size=41, dtype="float64", jitter=1e-5,
                      f_method=f_method)
    consts = make_constants(cfg, np.zeros((3, N_ITEMS)), np.full((3, N_ITEMS), 3.0),
                            np.zeros((2, N_RESP)), np.zeros((2, N_RESP)), device="cpu")
    gen = torch.Generator().manual_seed(7)
    theta0 = torch.as_tensor(rng.normal(size=(K, 1, N_RESP)))
    thr = torch.as_tensor(np.tile([-np.inf, 0.0, np.inf], (1, N_ITEMS, 1)))
    state = chain_start(gen, theta0, thr, y, consts, cfg)[-1]()
    return gen, Carry(state), y, consts, cfg


def _sweeps(chains, start, stop):
    gen, carry, y, consts, cfg = chains
    return advance_chains(gen, carry, y, consts, cfg, sample_schedule(10, 0, 1), start, stop)


def test_off_span_is_the_shared_noop_and_records_nothing(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    calls = []
    monkeypatch.setattr(time, "time_ns", lambda: calls.append(1) or 0)
    monkeypatch.setattr(time, "perf_counter", lambda: calls.append(1) or 0.0)
    assert span("sweep", 3) is span("sweep.theta") is _spans._NOOP
    with span("sweep.theta"):  # warm
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with span("sweep.theta"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == _spans.__file__ and d.size_diff > 0]
    assert not grown, grown
    assert not calls
    assert spans() == [] and span_totals() == {}


@pytest.mark.parametrize("f_method", ["conjugate", "grid", "two_stage"])
def test_recording_nests_each_family_blocks_in_its_sweep(f_method):
    chains = _chains(f_method)
    with recording():
        _sweeps(chains, 4, 6)
    recs = spans()
    roots = [s for s in recs if s.name == "sweep"]
    assert [r.it for r in roots] == [4, 5] and all(r.parent is None for r in roots)
    for root in roots:
        kids = [s for s in recs if s.parent == root.id]
        assert {s.name for s in kids} == BLOCKS[f_method]
        assert all(s.it == root.it for s in kids)
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns  # in order, none overlapping
        assert root.start_ns <= kids[0].start_ns and kids[-1].end_ns <= root.end_ns
    assert len(recs) == len(roots) + sum(1 for s in recs if s.parent in {r.id for r in roots})
    # the recorder is off again outside the block
    _sweeps(chains, 6, 7)
    assert len(spans()) == len(recs)


def test_a_recorded_sweep_is_the_unrecorded_sweep_bit_for_bit():
    plain, recorded = _chains("conjugate"), _chains("conjugate")
    want = _sweeps(plain, 0, 3)
    with recording():
        got = _sweeps(recorded, 0, 3)
    assert sum(s.name == "sweep" for s in spans()) == 3
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(plain[1].state, recorded[1].state):
        assert torch.equal(a, b)
    assert torch.equal(plain[0].get_state(), recorded[0].get_state())


def test_spans_record_under_a_profiler_on_its_clock():
    """Each span holds the starts of the aten ops launched inside it, as the
    profiler reports them, and none launched before or after it. The
    profiler converts its own clock to Unix-epoch ns; its converter is
    allowed a skew of at most 50 us, and the ops outside a span run 2 ms
    away from it."""
    skew = 50_000
    a = torch.randn(1000)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.add(a, 1)
        time.sleep(0.002)
        with span("outer", 9):
            torch.mul(a, 2)
            time.sleep(0.002)
            with span("inner"):
                torch.exp(a)
        time.sleep(0.002)
        torch.sub(a, 1)
    with span("after"):  # the profiler has stopped
        torch.sub(a, 1)
    recs = {s.name: s for s in spans()}
    assert set(recs) == {"outer", "inner"}
    assert recs["inner"].parent == recs["outer"].id and recs["inner"].it == 9
    starts = {}
    events = prof.profiler.kineto_results.events()
    for ev in events:
        starts.setdefault(ev.name(), ev.start_ns())
    assert not {ev.name() for ev in events} & {"outer", "inner", "after"}

    def inside(name, s):
        return s.start_ns - skew <= starts[name] <= s.end_ns + skew

    assert inside("aten::mul", recs["outer"]) and inside("aten::exp", recs["outer"])
    assert inside("aten::exp", recs["inner"]) and not inside("aten::mul", recs["inner"])
    assert not inside("aten::add", recs["outer"]) and not inside("aten::sub", recs["outer"])


def test_span_totals_count_and_self_time():
    with recording():
        for _ in range(2):
            with span("root", 0):
                with span("a"):
                    time.sleep(0.001)
                with span("b"):
                    with span("a"):
                        pass
    recs = spans()
    tot = span_totals()
    assert {k: v.count for k, v in tot.items()} == {"root": 2, "a": 4, "b": 2}
    dur = {s.id: s.end_ns - s.start_ns for s in recs}
    for name in tot:
        own = [s for s in recs if s.name == name]
        kids = sum(dur[c.id] for c in recs for s in own if c.parent == s.id)
        assert tot[name].host_ns == sum(dur[s.id] for s in own)
        assert tot[name].self_ns == tot[name].host_ns - kids
        if not torch.cuda.is_initialized():  # the host interval stands in for the stream
            assert tot[name].stream_ms == pytest.approx(tot[name].host_ns / 1e6)
    assert tot["a"].self_ns == tot["a"].host_ns and tot["root"].self_ns < tot["root"].host_ns


def test_the_recorder_keeps_a_bounded_number(monkeypatch):
    monkeypatch.setattr(_spans, "MAX_SPANS", 3)
    with recording():
        for _ in range(5):
            with span("x"):
                pass
    assert len(spans()) == 3 and profiling.span.dropped == 2
    clear_spans()
    assert spans() == [] and profiling.span.dropped == 0
