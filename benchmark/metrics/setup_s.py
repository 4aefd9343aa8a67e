"""Host seconds from process start to the first timed sweep: imports, data,
constants, the kernel's library, SMC, burn-in and warm-up."""


def read(run):
    return run["setup_s"]
