"""Campaign engine: resumable, cache-aware scheduling of whole
defense x attack x topology sweeps on the card.

The port's copy of the JAX package's ``campaigns`` package: a scheduler
that expands a declarative :class:`CampaignSpec` into config cells,
pre-validates every cell against the engine's composition-rejection
matrix, orders them, and executes them (in-process, grid-style, or each
as a child under the port's supervisor, ``supervisor.py``) under a
campaign-level exactly-once journal, so a SIGKILL mid-campaign costs
only the cell in flight.  ``runs campaign <id>`` renders the result
tables from the run registry.  The port's campaign runs port cells only.
"""

from attacking_federate_learning_tpu_torch.campaigns.journal import (
    TERMINAL_STATES, CampaignJournal
)
from attacking_federate_learning_tpu_torch.campaigns.scheduler import (
    EXIT_DEADLINE, Campaign, order_cells
)
from attacking_federate_learning_tpu_torch.campaigns.spec import (
    CampaignSpec, Cell, apply_attack, cell_id_for,
    composition_reject_reason, config_signature
)

__all__ = ["TERMINAL_STATES", "CampaignJournal", "EXIT_DEADLINE",
           "Campaign", "order_cells", "CampaignSpec", "Cell",
           "apply_attack", "cell_id_for", "composition_reject_reason",
           "config_signature"]
