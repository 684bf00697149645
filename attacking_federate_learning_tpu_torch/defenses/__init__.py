from attacking_federate_learning_tpu_torch.defenses import median  # noqa: F401  (registers "Median")
from attacking_federate_learning_tpu_torch.defenses import (  # noqa: F401  (the beyond-reference five)
    centeredclip, dnc, fltrust, geomed, normbound
)
from attacking_federate_learning_tpu_torch.defenses.kernels import (  # noqa: F401
    DEFENSES, check_defense_args
)
