"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import LMConfig, MoEConfig, register

CONFIG = register(LMConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                # dense ffn width == expert width for this model
    vocab=49155,
    d_head=64,
    attn_type="gqa",
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    activation="silu_glu",
    rope_theta=10000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
