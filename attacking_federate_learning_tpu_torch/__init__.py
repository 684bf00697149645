"""PyTorch/CUDA port of the federated-learning attack/defense simulator.

A second package beside the JAX one (``attacking_federate_learning_tpu``,
the reference it is held against), with the same layout.  It imports
neither JAX nor the JAX package.  Its entry points run on the card
(``cuda``) unless the caller passes ``device="cpu"``; the defense kernels
are hand-written CUDA C++ (``csrc/``), built with ``nvcc`` at first use
(``ops/_build.py``).
"""
