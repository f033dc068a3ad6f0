"""MeshGraphNet [arXiv:2010.03409]: 15 layers, 128 hidden, sum agg, 2-layer MLPs."""
from repro_torch.configs.base import Arch
from repro_torch.configs.gnn_shapes import GNN_SHAPES
from repro_torch.models.gnn.meshgraphnet import MGNConfig

ARCH = Arch(
    id="meshgraphnet",
    family="gnn",
    source="arXiv:2010.03409",
    config=MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2),
    smoke=MGNConfig(n_layers=3, d_hidden=32, mlp_layers=2),
    shapes=dict(GNN_SHAPES),
)
