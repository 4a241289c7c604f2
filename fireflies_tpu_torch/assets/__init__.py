from fireflies_tpu_torch.assets import procedural, scenes  # noqa: F401
