"""MLPerf Inference's DLRM-DCNv2 (mlcommons/inference
``recommendation/dlrm_v2``: torchrec's ``DLRM_DCN`` on the Criteo 1TB
multi-hot set): 26 tables of their own row counts and multi-hot bag
lengths at D 128, pooled by sum; a bottom MLP 13-512-256-128; the 27
features concatenated (3,456 wide) into three low-rank cross layers of
rank 512, ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l`` (DCN-V2,
arXiv:2008.13535 section 3); a top MLP 3456-1024-1024-512-256-1 and a
sigmoid."""
from repro_torch.configs.base import DLRMDCNConfig, register

VOCAB_SIZES = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
               40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14,
               40000000, 40000000, 40000000, 590152, 12973, 108, 36)
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)

CONFIG = register(DLRMDCNConfig(
    name="dlrm-dcnv2", emb_num=max(VOCAB_SIZES), emb_dim=128,
    bottom_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
    n_tables=len(VOCAB_SIZES), pooling=MULTI_HOT, n_dense=13,
    vocab_sizes=VOCAB_SIZES, cross_layers=3, cross_rank=512,
    source="MLPerf Inference dlrm_v2 (torchrec DLRM_DCN); "
           "arXiv:2008.13535"))
