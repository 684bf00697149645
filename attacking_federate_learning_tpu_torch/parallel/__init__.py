# The device mesh over the clients axis (parallel/mesh.py), the blockwise
# distances over it (parallel/distances.py) and joining a process group
# (parallel/multihost.py).
from attacking_federate_learning_tpu_torch.parallel.mesh import (  # noqa: F401
    CLIENTS, MODEL, MeshPlan, make_mesh, make_plan
)
from attacking_federate_learning_tpu_torch.parallel import (  # noqa: F401
    multihost
)
