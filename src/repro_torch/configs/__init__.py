from repro_torch.configs.base import (  # noqa: F401
    Config, DLRMConfig, LM_SHAPES, LMConfig, LMShape, MLAConfig, MoEConfig,
    REC_SHAPES, RecConfig, RecShape, get_config, list_archs, reduced,
    reduced_shape, register,
)
