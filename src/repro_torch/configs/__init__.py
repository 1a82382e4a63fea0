from repro_torch.configs.base import (  # noqa: F401
    GNN_SHAPES, LM_SHAPES, REC_SHAPES, Config, DLRMConfig, DLRMDCNConfig,
    GNNConfig, GNNShape,
    LMConfig, LMShape, MLAConfig, MoEConfig, RecConfig, RecShape, get_config,
    iter_cells, list_archs, reduced, reduced_shape, register,
)
