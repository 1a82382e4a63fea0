"""deepseek-67b [arXiv:2401.02954]: dense llama-arch, GQA kv=8."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    name="deepseek-67b",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    d_head=128,
    attn_type="gqa",
    activation="silu_glu",
    rope_theta=10000.0,
    remat="full",
    train_accum=4,
    source="arXiv:2401.02954",
))
