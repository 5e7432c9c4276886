from repro_torch.optim.adamw import adamw  # noqa: F401
