from repro_torch.configs.base import (  # noqa: F401
    GNN_SHAPES, LM_SHAPES, REC_SHAPES, Config, DLRMConfig, GNNConfig, GNNShape,
    LMConfig, LMShape, MLAConfig, MoEConfig, RecConfig, RecShape, get_config,
    list_archs, reduced, reduced_shape, register,
)
