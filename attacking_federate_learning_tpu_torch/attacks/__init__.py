from attacking_federate_learning_tpu_torch.attacks.alie import (  # noqa: F401
    DriftAttack, paper_z
)
from attacking_federate_learning_tpu_torch.attacks.base import (  # noqa: F401
    Attack, NoAttack
)
