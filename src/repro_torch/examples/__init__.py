"""The Launchpad examples on the port: ``python -m
repro_torch.examples.<name> --device cpu`` (the default is ``cuda``).
Their twins over the JAX package are under ``examples/``."""
