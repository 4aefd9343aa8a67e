"""Host seconds of ``make_constants`` on the device, synchronized: the grid
Gram, its Cholesky and eigenbasis, built in float64 on the host."""


def read(run):
    return run["constants_s"]
