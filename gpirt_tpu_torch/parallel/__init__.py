"""SMC annealed initialization, parallel tempering, and chains, items and
respondents over a torch.distributed DeviceMesh."""

from gpirt_tpu_torch.parallel.chains import make_chain_mesh
from gpirt_tpu_torch.parallel.items import make_item_mesh, run_chains_itemsharded
from gpirt_tpu_torch.parallel.respondents import (
    make_respondent_mesh,
    run_chains_respondentsharded,
)

__all__ = [
    "make_chain_mesh",
    "make_item_mesh",
    "run_chains_itemsharded",
    "make_respondent_mesh",
    "run_chains_respondentsharded",
]
