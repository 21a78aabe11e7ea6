"""GSL-LPA as a framework feature: MoE expert placement from co-activation,
on the PyTorch port.

    PYTHONPATH=src python examples/moe_expert_placement_torch.py    # CUDA
    PYTHONPATH=src python examples/moe_expert_placement_torch.py --device cpu

The twin of ``examples/moe_expert_placement.py`` over ``repro_torch.core``:
builds the expert co-activation graph from (simulated) router statistics
of a 64-expert MoE, detects communities of frequently co-activated experts
with GSL-LPA, and packs communities onto devices to minimise cross-device
all-to-all traffic.  The paper's guarantee of no internally disconnected
community is what makes the packing sound: a disconnected "community"
would co-locate experts that never fire together.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import build_graph, disconnected_fraction, gsl_lpa


def simulate_router_stats(n_experts=64, n_groups=8, tokens=20000, top_k=2,
                          seed=0):
    """Tokens pick experts with strong intra-group affinity: the
    co-activation counts (E, E) and each expert's planted group."""
    rng = np.random.default_rng(seed)
    group_of = np.repeat(np.arange(n_groups), n_experts // n_groups)
    co = np.zeros((n_experts, n_experts), dtype=np.int64)
    for _ in range(tokens):
        g = rng.integers(n_groups)
        members = np.where(group_of == g)[0]
        if rng.random() < 0.85:          # affinity pick
            pair = rng.choice(members, size=top_k, replace=False)
        else:                            # random pick
            pair = rng.choice(n_experts, size=top_k, replace=False)
        for a in pair:
            for b in pair:
                if a != b:
                    co[a, b] += 1
    return co, group_of


def coactivation_graph(co, device="cpu"):
    """The undirected graph of co-activated expert pairs, weighted by
    their count."""
    e = np.argwhere(np.triu(co, 1) > 0)
    w = co[e[:, 0], e[:, 1]].astype(np.float32)
    return build_graph(e, w, n=co.shape[0], device=device)


def pack(labels, n_devices=8):
    """Greedy packing: communities, largest first, each onto the device
    holding the fewest experts so far.  Returns each expert's device."""
    comm_ids, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts)
    device_of = np.zeros(labels.shape[0], dtype=np.int64)
    load = np.zeros(n_devices, dtype=np.int64)
    for c in comm_ids[order]:
        d = int(np.argmin(load))
        device_of[labels == c] = d
        load[d] += int((labels == c).sum())
    return device_of


def placement_cost(co, device_of):
    """Cross-device co-activation volume (all-to-all bytes proxy)."""
    cross = co * (device_of[:, None] != device_of[None, :])
    return int(cross.sum()) // 2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the fit runs (default: cuda)")
    device = ap.parse_args(argv).device
    co, _truth = simulate_router_stats()
    g = coactivation_graph(co, device)

    res = gsl_lpa(g, split="lp", device=device)
    frac = float(disconnected_fraction(g, torch.from_numpy(res.labels)))
    print(f"expert co-activation graph: {g.num_edges} edges, "
          f"{len(set(res.labels.tolist()))} communities, "
          f"disconnected={frac:.0%}")

    device_of = pack(res.labels, n_devices=8)
    rng = np.random.default_rng(1)
    random_placement = rng.permutation(co.shape[0]) % 8
    cost_lpa = placement_cost(co, device_of)
    cost_rand = placement_cost(co, random_placement)
    print(f"cross-device co-activation: random={cost_rand}  "
          f"gsl-lpa={cost_lpa}  ({1 - cost_lpa / cost_rand:.0%} less "
          f"all-to-all traffic)")
    assert cost_lpa < cost_rand


if __name__ == "__main__":
    main()
