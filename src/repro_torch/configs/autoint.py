"""autoint [arXiv:1810.11921]: self-attention feature interaction over Criteo.

39 sparse fields = 13 discretized numerical + 26 categorical (Criteo convention
in the AutoInt paper).  Categorical cardinalities follow the public Criteo
Kaggle field statistics; numerical fields are bucketized to 64 bins.
"""
from repro_torch.configs.base import RecConfig, register

CRITEO_CAT_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)

CONFIG = register(RecConfig(
    name="autoint",
    interaction="self-attn",
    embed_dim=16,
    vocab_sizes=tuple([64] * 13) + CRITEO_CAT_VOCABS,
    n_attn_layers=3,
    n_heads=2,
    d_attn=32,
    mlp_dims=(),
    source="arXiv:1810.11921",
))
