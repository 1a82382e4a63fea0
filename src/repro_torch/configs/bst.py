"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (Alibaba).

Item catalogue at Taobao scale (1M hashed ids) + item-category side feature;
sequence of 20 recent behaviours + target item -> transformer block -> MLP.
"""
from repro_torch.configs.base import RecConfig, register

CONFIG = register(RecConfig(
    name="bst",
    interaction="transformer-seq",
    embed_dim=32,
    vocab_sizes=(1_000_000, 10_000),   # (item id, category id)
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    n_dense=8,                          # user/context profile features
    mlp_dims=(1024, 512, 256),
    source="arXiv:1905.06874",
))
