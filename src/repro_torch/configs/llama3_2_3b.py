"""llama3.2-3b [hf:meta-llama/Llama-3.2-*; assigned dims]."""
from repro_torch.configs.base import LMConfig, register

CONFIG = register(LMConfig(
    name="llama3.2-3b",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    d_head=128,
    attn_type="gqa",
    activation="silu_glu",
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-3B",
))
