"""Core GSL-LPA building blocks in PyTorch: graph, propagation, split."""
from repro_torch.core.detect import (  # noqa: F401
    disconnected_communities,
    disconnected_communities_host,
    disconnected_fraction,
)
from repro_torch.core.graph import (  # noqa: F401
    Graph,
    build_graph,
    graph_fingerprint,
    graph_from_arrays,
    to_numpy_adj,
    to_padded_neighbors,
)
from repro_torch.core.lpa import label_hash, lpa_move, lpa_run  # noqa: F401
from repro_torch.core.modularity import modularity  # noqa: F401
from repro_torch.core.split import (  # noqa: F401
    compact_labels,
    num_communities,
    split_bfs_host,
    split_lp,
    split_lpp,
)
