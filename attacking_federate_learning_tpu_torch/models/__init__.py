from attacking_federate_learning_tpu_torch.models.base import (  # noqa: F401
    MODELS, get_model
)

# Import for registry side effects.
from attacking_federate_learning_tpu_torch.models import mnist  # noqa: F401
from attacking_federate_learning_tpu_torch.models import mnist_cnn  # noqa: F401
from attacking_federate_learning_tpu_torch.models import cifar10  # noqa: F401
from attacking_federate_learning_tpu_torch.models import wideresnet  # noqa: F401
from attacking_federate_learning_tpu_torch.models import resnet  # noqa: F401
