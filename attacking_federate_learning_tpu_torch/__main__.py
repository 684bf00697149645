from attacking_federate_learning_tpu_torch.cli import main

main()
