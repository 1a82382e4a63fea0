"""The paper's own models (PIFS-Rec Table I): RMC1-4.

Emb.Num is rows *per table*; the evaluation (section VI-C) runs 8 tables
with 8 lookups per bag, which are the defaults here.
"""
from repro_torch.configs.base import DLRMConfig, register

RMC1 = register(DLRMConfig(
    name="rmc1", emb_num=16384, emb_dim=64,
    bottom_mlp=(256, 128, 128), top_mlp=(128, 64, 1)))

RMC2 = register(DLRMConfig(
    name="rmc2", emb_num=131072, emb_dim=64,
    bottom_mlp=(1024, 512, 128), top_mlp=(384, 192, 1)))

RMC3 = register(DLRMConfig(
    name="rmc3", emb_num=1048576, emb_dim=64,
    bottom_mlp=(2048, 1024, 256), top_mlp=(512, 256, 1)))

RMC4 = register(DLRMConfig(
    name="rmc4", emb_num=1048576, emb_dim=128,
    bottom_mlp=(2048, 2048, 256), top_mlp=(768, 384, 1)))
