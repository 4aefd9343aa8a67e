"""gpirt_tpu_torch: the GP-IRT sampler in PyTorch for one NVIDIA H100.

A port of ``gpirt_tpu`` (JAX), which stays beside it as the reference. The
port covers binary and ordinal single-session data through the conjugate
sweep (cutpoints by y-marginal ESS or Newton-proposal MH), SMC annealed
initialization and the lockstep K-chain sampling loop; the binary cutpoint
ESS runs in a hand-written CUDA kernel (``csrc/threshold_ess.cu``) on the
card and in its plain PyTorch version on the CPU.
"""

from gpirt_tpu_torch.api import default_thresholds, gpirt_mcmc
from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants, make_constants
from gpirt_tpu_torch.models.gibbs import GPIRTState

__all__ = [
    "gpirt_mcmc",
    "default_thresholds",
    "GPIRTConfig",
    "GPIRTConstants",
    "GPIRTState",
    "make_constants",
]
