"""One CPU thread for torch and for numpy's BLAS in every process of the
port's tests.

Every ``test_torch_*.py`` module imports this for its effect (the card's
tests, ``test_torch_gpu.py``, excepted). The Gloo ranks the tests start run
no more torch threads than the process that starts them
(``parallel.distributed.launch``), and, fresh interpreters, read numpy's
BLAS thread count from the environment set here. The tier-1 command runs
six pytest workers on the host's cores, and torch's OpenMP threads and
OpenBLAS's threads (one a core each by default) spin while they wait: two
of chip_smoke's reduced-size tests took 363 s of CPU beside a running
suite with numpy's default threads and 14 s with one. Ranks and the
process that starts them keep one count, so that host factorizations give
the same bits in both. Each xdist worker imports every test module when it
collects, so in that run the JAX package's tests share the cap too.

The host constants' bits follow the BLAS thread count, and two tests hold
numbers at the bits the default count gives:
``test_torch_two_stage.py::test_two_stage_sweep_newton_matches`` (a
float64 sweep against JAX's through near-singular f* solves, to 1e-8) and
``test_torch_chip_smoke_mesh.py`` (phase 38's float32 f* at the reduced
size, to 1e-3). They take :func:`default_blas_threads`.
"""

import os

import pytest
import torch

THREADS = 1
os.environ["OPENBLAS_NUM_THREADS"] = str(THREADS)
torch.set_num_threads(THREADS)
try:  # numpy is imported already: set its BLAS pool in this process too
    from threadpoolctl import threadpool_limits
except ImportError:  # only the ranks then read the environment's count
    threadpool_limits = None
    _DEFAULT_BLAS = None
else:
    _DEFAULT_BLAS = threadpool_limits(THREADS, user_api="blas").get_original_num_threads()[
        "blas"]


@pytest.fixture
def default_blas_threads():
    """numpy's BLAS at the host's default thread count for a test and for
    the ranks it starts (the environment's count removed); the host
    constants ``gpirt_mcmc`` caches are dropped before and after it, so
    that no other test reads constants of the other count."""
    from gpirt_tpu_torch import api

    env = os.environ.pop("OPENBLAS_NUM_THREADS", None)
    api._CONSTS_CACHE.clear()
    try:
        if threadpool_limits is None or _DEFAULT_BLAS is None:
            yield
        else:
            with threadpool_limits(_DEFAULT_BLAS, user_api="blas"):
                yield
    finally:
        api._CONSTS_CACHE.clear()
        if env is not None:
            os.environ["OPENBLAS_NUM_THREADS"] = env
