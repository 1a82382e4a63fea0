"""graphsage-reddit [arXiv:1706.02216]: 2 layers, mean agg, fanout 25-10."""
from repro_torch.configs.base import GNNConfig, register

CONFIG = register(GNNConfig(
    name="graphsage-reddit",
    n_layers=2,
    d_hidden=128,
    aggregator="mean",
    sample_sizes=(25, 10),
    n_classes=41,             # Reddit community labels
    source="arXiv:1706.02216",
))
