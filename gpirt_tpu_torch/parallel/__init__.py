"""SMC annealed initialization, parallel tempering, and chains, items,
respondents and campaigns over a torch.distributed DeviceMesh."""

from gpirt_tpu_torch.parallel.chains import (
    CAMPAIGN_AXIS,
    CHAIN_AXIS,
    make_campaign_mesh,
    make_chain_mesh,
)
from gpirt_tpu_torch.parallel.items import make_item_mesh, run_chains_itemsharded
from gpirt_tpu_torch.parallel.respondents import (
    RESPONDENT_AXIS,
    make_respondent_mesh,
    run_chains_respondentsharded,
)

__all__ = [
    "CHAIN_AXIS",
    "CAMPAIGN_AXIS",
    "RESPONDENT_AXIS",
    "make_chain_mesh",
    "make_campaign_mesh",
    "make_item_mesh",
    "run_chains_itemsharded",
    "make_respondent_mesh",
    "run_chains_respondentsharded",
]
