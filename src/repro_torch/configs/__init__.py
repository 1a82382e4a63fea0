from repro_torch.configs.base import (  # noqa: F401
    DLRMConfig, get_config, reduced, register,
)
