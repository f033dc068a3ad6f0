"""GraphSAGE-Reddit [arXiv:1706.02216]: 2 layers, 128 hidden, mean agg,
sample sizes 25-10 (the minibatch_lg shape samples with the assigned 15-10)."""
from repro_torch.configs.base import Arch
from repro_torch.configs.gnn_shapes import GNN_SHAPES
from repro_torch.models.gnn.graphsage import SageConfig

ARCH = Arch(
    id="graphsage-reddit",
    family="gnn",
    source="arXiv:1706.02216",
    config=SageConfig(n_layers=2, d_in=602, d_hidden=128, n_classes=41,
                      aggregator="mean", sample_sizes=(25, 10)),
    smoke=SageConfig(n_layers=2, d_in=32, d_hidden=16, n_classes=4,
                     sample_sizes=(5, 5)),
    shapes=dict(GNN_SHAPES),
)
