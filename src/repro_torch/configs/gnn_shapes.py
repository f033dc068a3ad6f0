"""The four assigned GNN input shapes (shared by all 4 GNN archs).

Numbers are taken verbatim from the assignment; n_edges is treated as the
directed-edge array length.  ``minibatch_lg`` describes the *sampled batch*
(padded shapes) plus the full-graph stats the neighbor sampler draws from.
"""

GNN_SHAPES = {
    "full_graph_sm": {
        "kind": "train", "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
        "n_graphs": 1,
    },
    "minibatch_lg": {
        "kind": "train", "pad_nodes": 196608, "pad_edges": 262144,
        "d_feat": 602, "n_graphs": 1, "full_nodes": 232965,
        "full_edges": 114_615_892, "batch_nodes": 1024, "fanout": (15, 10),
    },
    "ogb_products": {
        "kind": "train", "n_nodes": 2_449_029, "n_edges": 61_859_140,
        "d_feat": 100, "n_graphs": 1,
    },
    "molecule": {
        "kind": "train", "n_nodes": 30 * 128, "n_edges": 64 * 128,
        "d_feat": 64, "n_graphs": 128, "atoms": 30,
    },
}
