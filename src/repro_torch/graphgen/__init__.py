from repro_torch.graphgen.synthetic import (  # noqa: F401
    erdos_renyi,
    figure1_graph,
    grid2d,
    karate_club,
    planted_partition,
    ring_of_cliques,
    rmat,
    sbm,
)
