"""nemotron-4-340b [arXiv:2402.16819]: dense, GQA kv=8, squared-ReLU FFN."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    name="nemotron-4-340b",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    d_head=192,
    attn_type="gqa",
    activation="relu2",       # squared-ReLU, no GLU gate
    rope_theta=10000.0,
    remat="full",
    train_accum=16,
    source="arXiv:2402.16819",
))
