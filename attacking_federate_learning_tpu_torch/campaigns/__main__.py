from attacking_federate_learning_tpu_torch.campaigns.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
