"""The device's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``, reset at process start), in GiB; read
before the reference runs."""


def read(run):
    return run["memory_peak_bytes"] / 2 ** 30 if run["memory_peak_bytes"] else None
