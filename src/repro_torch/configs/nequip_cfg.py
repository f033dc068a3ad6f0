"""NequIP [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 rbf, cutoff 5.

E(3)-equivariant; tensor products realized as closed-form l<=2 covariant
products (DESIGN.md §6).
"""
from repro_torch.configs.base import Arch
from repro_torch.configs.gnn_shapes import GNN_SHAPES
from repro_torch.models.gnn.nequip import NequipConfig

ARCH = Arch(
    id="nequip",
    family="gnn",
    source="arXiv:2101.03164",
    config=NequipConfig(n_layers=5, d_hidden=32, l_max=2, n_rbf=8, cutoff=5.0),
    smoke=NequipConfig(n_layers=2, d_hidden=8, l_max=2, n_rbf=6, cutoff=3.0),
    shapes=dict(GNN_SHAPES),
)
