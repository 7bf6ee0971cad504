from repro_torch.parallel import ctx  # noqa: F401
