"""deepseek-v3-671b [arXiv:2412.19437]: MLA, 1 shared + 256 routed top-8, MTP."""
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig, register

CONFIG = register(LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: kv latent shared; head count for q/k after up-proj
    d_ff=18432,              # dense FFN width (first_dense_layers)
    vocab=129280,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, first_dense_layers=3),
    activation="silu_glu",
    rope_theta=10000.0,
    mtp_depth=1,
    remat="full",
    train_accum=8,
    source="arXiv:2412.19437",
))
