"""Data loading, response recoding, diagnostics, checkpoints, IRF curves
and block timing."""

from gpirt_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    run_chain_checkpointed,
    run_chains_checkpointed,
    run_tempered_chains_checkpointed,
)
from gpirt_tpu_torch.utils.irf import irf_probabilities, posterior_irf
from gpirt_tpu_torch.utils.profiling import device_time, profile_sweep

__all__ = [
    "CheckpointManager",
    "run_chain_checkpointed",
    "run_chains_checkpointed",
    "run_tempered_chains_checkpointed",
    "irf_probabilities",
    "posterior_irf",
    "device_time",
    "profile_sweep",
]
