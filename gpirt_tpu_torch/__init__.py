"""gpirt_tpu_torch: the GP-IRT sampler in PyTorch for one NVIDIA H100.

A port of ``gpirt_tpu`` (JAX), which stays beside it as the reference. The
port covers binary and ordinal data over one session or a cube of
sessions, through the conjugate sweep or the reference's two-stage
pipeline (cutpoints by y-marginal ESS or Newton-proposal MH), SMC annealed
initialization or parallel tempering, the lockstep K-chain sampling loop,
R independent SMC campaigns and their campaign-replicated estimator
(``gpirt_campaigns``), convergence diagnostics, checkpoints that resume a
run bit for bit (``gpirt_mcmc(checkpoint_path=...)``,
``utils/checkpoint.py``), prior and posterior-predictive simulation
(``models/generate.py``), IRF curves (``posterior_irf``), block timing
(``profile_sweep``), and f* recovered from stored f draws
(``recover_fstar``, ``recover_fstar_batch``), with the chains, the items
and the respondents spread over the ranks of a ``torch.distributed``
``DeviceMesh`` (``gpirt_mcmc(mesh=..., item_axis=..., respondent_axis=...)``,
tempered or not, ``parallel/``) and the campaigns over a campaign axis
(``gpirt_campaigns(mesh=make_campaign_mesh())``); the binary cutpoint ESS runs in a hand-written CUDA kernel
(``csrc/threshold_ess.cu``) on the card, in its plain PyTorch version on
the CPU, and as a plain round loop whose lane totals are summed over the
ranks under a respondent axis.
"""

from gpirt_tpu_torch import ops
from gpirt_tpu_torch.api import (
    default_thresholds,
    gpirt_mcmc,
    recover_fstar,
    recover_fstar_batch,
)
from gpirt_tpu_torch.campaigns import campaign_schedule, gpirt_campaigns
from gpirt_tpu_torch.models.config import GPIRTConfig, GPIRTConstants, make_constants
from gpirt_tpu_torch.models.generate import (
    posterior_predictive,
    sample_prior_state,
    sample_responses,
)
from gpirt_tpu_torch.models.gibbs import GPIRTState
from gpirt_tpu_torch.models.sampler import memory_estimate_mb, run_chain
from gpirt_tpu_torch.parallel.chains import CAMPAIGN_AXIS, make_campaign_mesh
from gpirt_tpu_torch.utils.checkpoint import CheckpointManager
from gpirt_tpu_torch.utils.irf import irf_probabilities, posterior_irf
from gpirt_tpu_torch.utils.profiling import profile_sweep

__all__ = [
    "ops",
    "gpirt_mcmc",
    "gpirt_campaigns",
    "campaign_schedule",
    "CAMPAIGN_AXIS",
    "make_campaign_mesh",
    "recover_fstar",
    "recover_fstar_batch",
    "default_thresholds",
    "GPIRTConfig",
    "GPIRTConstants",
    "GPIRTState",
    "make_constants",
    "run_chain",
    "memory_estimate_mb",
    "CheckpointManager",
    "sample_prior_state",
    "sample_responses",
    "posterior_predictive",
    "irf_probabilities",
    "posterior_irf",
    "profile_sweep",
]
