"""The architecture registry of the port: the JAX package's ``configs/``
as data (``--arch <id>`` -> ``ModelConfig``), with no JAX import."""
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config

__all__ = ["ARCHS", "get_config", "get_smoke_config"]
