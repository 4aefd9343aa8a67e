"""gpirt_tpu_torch: the GP-IRT sampler in PyTorch for one NVIDIA H100.

A port of ``gpirt_tpu`` (JAX), which stays beside it as the reference. The
port covers binary and ordinal data over one session or a cube of
sessions, through the conjugate sweep or the reference's two-stage
pipeline (cutpoints by y-marginal ESS or Newton-proposal MH), SMC annealed
initialization or parallel tempering, the lockstep K-chain sampling loop,
R independent SMC campaigns and their campaign-replicated estimator
(``gpirt_campaigns``), convergence diagnostics, and f* recovered from
stored f draws (``recover_fstar``, ``recover_fstar_batch``); the binary
cutpoint ESS runs in a hand-written CUDA kernel (``csrc/threshold_ess.cu``)
on the card and in its plain PyTorch version on the CPU.
"""

from gpirt_tpu_torch.api import (
    default_thresholds,
    gpirt_mcmc,
    recover_fstar,
    recover_fstar_batch,
)
from gpirt_tpu_torch.campaigns import campaign_schedule, gpirt_campaigns
from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants, make_constants
from gpirt_tpu_torch.models.gibbs import GPIRTState

__all__ = [
    "gpirt_mcmc",
    "gpirt_campaigns",
    "campaign_schedule",
    "recover_fstar",
    "recover_fstar_batch",
    "default_thresholds",
    "GPIRTConfig",
    "GPIRTConstants",
    "GPIRTState",
    "make_constants",
]
