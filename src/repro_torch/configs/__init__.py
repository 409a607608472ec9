"""Model configurations (dense families served by the port)."""
from repro_torch.configs.base import (CacheTierSpec, ModelConfig,  # noqa: F401
                                     get_config)
