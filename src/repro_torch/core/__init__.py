"""Core GSL-LPA building blocks in PyTorch: graph, propagation, split,
batching and the ``gsl_lpa`` / ``gve_lpa`` facades."""
from repro_torch.core.batch import GraphBatch  # noqa: F401
from repro_torch.core.delta import (  # noqa: F401
    GraphDelta,
    affected_frontier,
    apply_delta,
    apply_delta_patch,
    undirected_edges,
)
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
from repro_torch.core.gsl import (  # noqa: F401
    SPLIT_METHODS,
    GslResult,
    gsl_lpa,
    gve_lpa,
)
from repro_torch.core.lpa import (  # noqa: F401
    LpaState,
    label_hash,
    lpa_move,
    lpa_move_reference,
    lpa_run,
)
from repro_torch.core.modularity import modularity  # noqa: F401
from repro_torch.core.split import (  # noqa: F401
    compact_labels,
    num_communities,
    split_bfs_host,
    split_lp,
    split_lpp,
)
