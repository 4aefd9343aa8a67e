"""Binary cutpoint ESS: the hand-written CUDA kernel, its wrapper, and its
plain PyTorch version.

The kernel (``csrc/threshold_ess.cu``) replaces the TPU kernel
``gpirt_tpu/ops/pallas_threshold.py::binary_threshold_ess_pallas``: one whole
elliptical-slice update of the binary interior cutpoint t_1 for every lane
(chain x horizon x item), the bracket-shrink loop included, in one launch.
It is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``gpirt_tpu_torch/_build/`` at first use and called through ``ctypes``.
A group of threads shares each lane's site sum; the kernel chooses the
group size from n at launch.

The uniforms (``logu``, ``eps0`` and the per-round table ``rs``) are inputs,
so the kernel and :func:`binary_threshold_ess_reference` compute the same
update from the same numbers. The round cap is ``rs.shape[0]``. The scale
``c`` is one float for every chain or a (K,) tensor of one a chain (the
lanes of parallel tempering, each at its own temperature); the kernel always
reads a (K,) vector, and a float becomes a cached one on the lanes' device.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import math
import os
import shutil
import subprocess

import torch

__all__ = [
    "binary_threshold_ess",
    "binary_threshold_ess_reference",
    "build",
]

_TWO_PI = 6.283185307179586
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lib = None
# (value, K, device) -> a (K,) float32 vector of one c, so that a sweep
# with a float c allocates nothing and never syncs with the host
_C_VECTORS = {}
_C_VECTORS_MAX = 1024


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into ``_build/`` once per source content and
    load it. Returns the compiler's report (register and spill counts with
    ``verbose``), or "" when the library was already built."""
    global _lib
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    digest = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as fh:
            digest.update(fh.read())
    path = os.path.join(_BUILD, f"libgpirt_kernels_{digest.hexdigest()[:16]}.so")
    report = "" if os.path.exists(path) else compile_library(srcs, path, verbose)
    if _lib is None:
        _lib = load_library(path)
    return report


def compile_library(srcs, path: str, verbose: bool = False) -> str:
    """nvcc the CUDA sources ``srcs`` for ``sm_90a`` into the shared library
    ``path``; returns the compiler's report."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), _ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, *srcs]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
    os.replace(tmp, path)
    return report


def load_library(path: str):
    """Load a library built from a source with the C entry
    ``gpirt_binary_threshold_ess`` and declare that entry's signature."""
    lib = ctypes.CDLL(path)
    lib.gpirt_binary_threshold_ess.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.gpirt_binary_threshold_ess.restype = ctypes.c_int
    return lib


def _check(g, y, t1, nu, logu, eps0, rs, c):
    if g.ndim != 4:
        raise ValueError(f"g must be (K, H, n, m), got {tuple(g.shape)}")
    K, H, n, m = g.shape
    if tuple(y.shape) != (H, n, m):
        raise ValueError(f"y must be (H, n, m) = {(H, n, m)}, got {tuple(y.shape)}")
    if y.dtype.is_floating_point or y.dtype == torch.bool:
        raise ValueError(f"y must hold integer categories, got {y.dtype}")
    for name, v in (("t1", t1), ("nu", nu), ("logu", logu), ("eps0", eps0)):
        if tuple(v.shape) != (K, H, m):
            raise ValueError(f"{name} must be (K, H, m) = {(K, H, m)}, "
                             f"got {tuple(v.shape)}")
    if rs.ndim != 4 or tuple(rs.shape[1:]) != (K, H, m) or rs.shape[0] < 1:
        raise ValueError(f"rs must be (R, K, H, m) with R >= 1, got {tuple(rs.shape)}")
    for name, v in (("t1", t1), ("nu", nu), ("logu", logu), ("eps0", eps0),
                    ("rs", rs)):
        if v.dtype != g.dtype:
            raise ValueError(f"{name} is {v.dtype}, g is {g.dtype}")
    for v in (y, t1, nu, logu, eps0, rs):
        if v.device != g.device:
            raise ValueError(f"inputs on {v.device} and {g.device}")
    if torch.is_tensor(c):
        if tuple(c.shape) != (K,):
            raise ValueError(f"c must be a float or (K,) = ({K},), got {tuple(c.shape)}")
        if c.dtype != g.dtype or c.device != g.device:
            raise ValueError(f"c is {c.dtype} on {c.device}, g is {g.dtype} on {g.device}")


def _per_chain_c(c, g):
    """``c`` shaped to broadcast over g (K, H, n, m): a float as it is, a
    (K,) tensor as (K, 1, 1, 1)."""
    return c.reshape(-1, 1, 1, 1) if torch.is_tensor(c) else c


def _c_vector(c: float, K: int, device) -> torch.Tensor:
    """The cached (K,) float32 vector of one ``c`` on ``device``."""
    key = (float(c), K, str(device))
    vec = _C_VECTORS.get(key)
    if vec is None:
        if len(_C_VECTORS) >= _C_VECTORS_MAX:
            _C_VECTORS.pop(next(iter(_C_VECTORS)))
        vec = _C_VECTORS[key] = torch.full((K,), float(c), dtype=torch.float32,
                                           device=device)
    return vec


def binary_threshold_ess_reference(g, y, t1, nu, logu, eps0, rs, c):
    """Plain PyTorch version of the kernel: a loop over rounds with an
    active mask.

    Args:
      g: (K, H, n, m) latent ``f + mu``.
      y: (H, n, m) int categories (1, 2; 0 = missing), shared by the chains.
      t1, nu: (K, H, m) current cutpoint and its N(0, 1) prior draw.
      logu: (K, H, m) log of the slice uniform.
      eps0: (K, H, m) initial angle in [0, 2 pi).
      rs: (R, K, H, m) shrink uniforms, one row per round; R is the cap.
      c: 1/sqrt(2), times 1/sqrt(T) when tempered: a float, or a (K,)
        tensor of one a chain.
    Returns:
      (K, H, m) updated cutpoints.
    """
    _check(g, y, t1, nu, logu, eps0, rs, c)
    c = _per_chain_c(c, g)
    obs = (y > 0).to(g.dtype)
    sgn = torch.where(y == 1, 1.0, -1.0).to(g.dtype) * obs

    def ll(t):  # (K, H, m) -> (K, H, m)
        x = sgn * (t.unsqueeze(-2) - g) * c
        return torch.sum(torch.log(0.5 * (1.0 + torch.erf(x)) + 1e-6) * obs, dim=-2)

    log_y = ll(t1) + logu
    eps = eps0
    eps_min = eps - _TWO_PI
    eps_max = torch.full_like(eps, _TWO_PI)
    x_out = t1
    active = torch.ones_like(t1, dtype=torch.bool)
    for r in range(rs.shape[0]):
        if not bool(active.any()):
            break
        prop = t1 * torch.cos(eps) + nu * torch.sin(eps)
        accept = ll(prop) > log_y
        x_out = torch.where(active & accept, prop, x_out)
        still = active & ~accept
        eps_min = torch.where(still & (eps < 0), eps, eps_min)
        eps_max = torch.where(still & (eps >= 0), eps, eps_max)
        eps = torch.where(still, eps_min + rs[r] * (eps_max - eps_min), eps)
        active = still
    return x_out


def _launch(g, y, t1, nu, logu, eps0, rs, c, lib=None):
    """Launch the kernel on checked CUDA tensors, from ``lib`` (a
    :func:`load_library`) or else this checkout's build. Returns the output,
    or raises."""
    if g.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32, got {g.dtype}")
    if y.dtype != torch.int32:
        raise ValueError(f"the CUDA kernel takes int32 y, got {y.dtype}")
    K, H, n, m = g.shape
    if torch.is_tensor(c):
        if not c.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
    else:
        if not math.isfinite(c):
            raise ValueError(f"c must be finite, got {c}")
        c = _c_vector(c, K, g.device)
    for v in (g, y, t1, nu, logu, eps0, rs):
        if not v.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
    if lib is None:
        if _lib is None:
            build()
        lib = _lib
    out = torch.empty_like(t1)
    ptrs = [v.data_ptr() for v in (g, y, t1, nu, logu, eps0, rs, c)]
    dims = [K, H, n, m, rs.shape[0]]
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.gpirt_binary_threshold_ess(*ptrs, out.data_ptr(), *dims, stream)
    if err != 0:
        raise RuntimeError(f"binary_threshold_ess launch failed: cudaError {err}")
    return out


def binary_threshold_ess(g, y, t1, nu, logu, eps0, rs, c):
    """One ESS update of every lane's binary cutpoint (arguments as in
    :func:`binary_threshold_ess_reference`; ``c`` a float or a (K,) tensor).

    CPU tensors take the plain version. CUDA tensors launch the kernel on
    the current stream (float32, contiguous, ``y`` int32) or raise; each
    launch adds one to ``binary_threshold_ess.launches``.
    """
    _check(g, y, t1, nu, logu, eps0, rs, c)
    if g.device.type == "cpu":
        return binary_threshold_ess_reference(g, y, t1, nu, logu, eps0, rs, c)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    if t1.numel() == 0:
        return torch.empty_like(t1)
    out = _launch(g, y, t1, nu, logu, eps0, rs, c)
    binary_threshold_ess.launches += 1
    return out


binary_threshold_ess.launches = 0

