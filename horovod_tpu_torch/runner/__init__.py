"""The launcher: ``python -m horovod_tpu_torch.runner.launch -np N cmd ...``."""
