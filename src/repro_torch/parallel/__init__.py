from repro_torch.parallel import ctx, sharding  # noqa: F401
