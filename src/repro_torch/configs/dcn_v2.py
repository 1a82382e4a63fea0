"""dcn-v2 [arXiv:2008.13535]: cross network v2 over Criteo (13 dense, 26 sparse)."""
from repro_torch.configs.autoint import CRITEO_CAT_VOCABS
from repro_torch.configs.base import RecConfig, register

CONFIG = register(RecConfig(
    name="dcn-v2",
    interaction="cross",
    embed_dim=16,
    vocab_sizes=CRITEO_CAT_VOCABS,
    n_dense=13,
    n_cross_layers=3,
    mlp_dims=(1024, 1024, 512),
    source="arXiv:2008.13535",
))
