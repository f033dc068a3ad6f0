"""SchNet [arXiv:1706.08566]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10."""
from repro_torch.configs.base import Arch
from repro_torch.configs.gnn_shapes import GNN_SHAPES
from repro_torch.models.gnn.schnet import SchNetConfig

ARCH = Arch(
    id="schnet",
    family="gnn",
    source="arXiv:1706.08566",
    config=SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0),
    smoke=SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=16, cutoff=3.0),
    shapes=dict(GNN_SHAPES),
)
