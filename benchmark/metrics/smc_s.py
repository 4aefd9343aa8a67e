"""Host seconds of the SMC anneal (``parallel/smc.anneal_init``),
synchronized; nothing where the configuration runs no SMC."""


def read(run):
    return run["smc_s"]
