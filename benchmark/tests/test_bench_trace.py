"""The trace arithmetic on events made by hand: busy time as the union of
the device's operations inside the window mark, the idle gaps named by the
innermost host operation in flight, and each launch's time."""

from benchmark.trace import WINDOW_MARK, first_launch, summarize


def test_busy_gaps_and_launches():
    ms = 1_000_000
    events = [
        (WINDOW_MARK, False, 0, 100 * ms),
        (WINDOW_MARK, True, 0, 100 * ms),  # its annotation on the device: not an operation
        ("kernel_a", True, 10 * ms, 20 * ms),  # 10-30
        ("kernel_b", True, 25 * ms, 15 * ms),  # 25-40, overlaps a
        ("ess_regs_kernel", True, 60 * ms, 10 * ms),  # 60-70
        ("kernel_a", True, 95 * ms, 10 * ms),  # 95-105: clipped at the window's end
        ("aten::item", False, 40 * ms, 20 * ms),  # the host waits 40-60
        ("outer_op", False, 70 * ms, 25 * ms),  # 70-95
        ("cudaLaunchKernel", False, 80 * ms, 2 * ms),  # inside outer_op, not at the gap's middle
    ]
    tr = summarize(events, sweeps=4)
    assert abs(tr.window_s - 0.1) < 1e-12
    assert abs(tr.busy_s - (0.030 + 0.010 + 0.005)) < 1e-12  # 10-40, 60-70, 95-100
    gaps = dict(tr.idle_gaps)
    assert abs(gaps["python"] - 0.010) < 1e-12  # 0-10
    assert abs(gaps["aten::item"] - 0.020) < 1e-12  # 40-60
    assert abs(gaps["outer_op"] - 0.025) < 1e-12  # 70-95
    assert [n for n, _ in tr.device_ops][0] == "kernel_a"
    assert abs(first_launch(tr, "ess_regs") - 0.010) < 1e-12


def test_no_device_operation_reads_nothing():
    assert summarize([(WINDOW_MARK, False, 0, 10), ("aten::add", False, 1, 2)], 1) is None
