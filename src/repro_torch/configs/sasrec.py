"""sasrec [arXiv:1808.09781]: self-attentive sequential recommendation.

Paper dims: embed 50, 2 blocks, 1 head, seq 50.  Item vocabulary is dataset
dependent; a production-scale 1M-item catalogue, so the embedding engine
and the retrieval_cand shape (1M candidates) run at scale.
"""
from repro_torch.configs.base import RecConfig, register

CONFIG = register(RecConfig(
    name="sasrec",
    interaction="self-attn-seq",
    embed_dim=50,
    vocab_sizes=(1_000_000,),  # item catalogue
    seq_len=50,
    n_blocks=2,
    n_heads=1,
    mlp_dims=(),
    source="arXiv:1808.09781",
))
