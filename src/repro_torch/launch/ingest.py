"""Ingest CLI: parse, preprocess and store a real graph file.

    python -m repro_torch.launch.ingest file.mtx --stats
    python -m repro_torch.launch.ingest file.snap.txt \
        --one-based --largest-cc --detect --backend segment
    python -m repro_torch.launch.ingest file.mtx --detect --device cpu
    python -m repro_torch.launch.ingest file.mtx --ooc --memory-budget 256MB
    python -m repro_torch.launch.ingest --list-cache

One run pays the parse; the CSR lands in the on-disk store
(``repro_torch.io.store.default_cache_dir`` or ``--cache-dir``), so every
later ``load_graph`` / ``Engine.fit(path)`` on the same file content maps
the stored arrays.  ``--stats`` prints the §4.1 preprocessing report (raw
against cleaned edge counts); ``--detect`` also runs one engine fit, on
CUDA unless ``--device cpu`` is given, and reports communities and
modularity.  ``--ooc`` runs an out-of-core detection over the store entry
under ``--memory-budget`` (default 64MB), on the same device: windowed
reads of the stored arrays, never the full edge arrays.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.io.preprocess import PreprocessOptions
from repro_torch.io.store import CsrStore, load_graph


def _human_edges_per_s(edges: int, seconds: float) -> str:
    if seconds <= 0:
        return "-"
    rate = edges / seconds
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if rate >= div:
            return f"{rate / div:.2f}{unit} edges/s"
    return f"{rate:.0f} edges/s"


def _human_bytes(n: int) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if n >= div:
            return f"{n / div:.1f}{unit}"
    return f"{n}B"


def ingest(path: str, args) -> dict:
    opts = PreprocessOptions(
        drop_self_loops=not args.keep_self_loops,
        dedup=not args.no_dedup,
        unit_weights=not args.keep_weights,
        largest_component=args.largest_cc,
        compact_ids=args.compact_ids,
    )
    if args.ooc:
        # --ooc never materializes the full edge arrays: it goes through
        # the windowed store handle, not load_graph
        return _ingest_ooc(path, args, opts)
    graph, rep = load_graph(
        path, opts, fmt=args.format, one_based=args.one_based,
        cache=not args.no_cache, cache_dir=args.cache_dir,
        force=args.force, return_report=True)

    s = rep.stats
    mode = "cache hit" if rep.cache_hit else "ingested"
    print(f"[ingest] {path}: {mode} (key {rep.key or '-'})")
    print(f"  graph: n={graph.n} directed_edges={graph.num_edges} "
          f"d_avg={graph.num_edges / max(graph.n, 1):.1f}")
    if rep.cache_hit:
        print(f"  load: {rep.load_seconds * 1e3:.1f}ms mmap "
              f"(+{rep.hash_seconds * 1e3:.1f}ms content hash)")
    else:
        print(f"  parse: {rep.parse_seconds:.3f}s "
              f"({_human_edges_per_s(s.get('raw_edges', 0), rep.parse_seconds)})"
              f"  preprocess: {rep.preprocess_seconds:.3f}s"
              f"  build: {rep.build_seconds:.3f}s"
              f"  store: {rep.save_seconds:.3f}s")
    _print_stats(args, s)

    out = {"path": path, "cache_hit": rep.cache_hit, "key": rep.key,
           "n": graph.n, "directed_edges": graph.num_edges,
           "parse_seconds": rep.parse_seconds,
           "preprocess_seconds": rep.preprocess_seconds,
           "build_seconds": rep.build_seconds,
           "save_seconds": rep.save_seconds,
           "load_seconds": rep.load_seconds, "stats": s}

    if args.detect:
        from repro_torch.engine import Engine, EngineConfig
        eng = Engine(EngineConfig(backend=args.backend, device=args.device,
                                  compute_metrics=True))
        res = eng.fit(graph)
        print(f"  detect[{res.backend}, {res.device}]: "
              f"|Gamma|={res.num_communities} Q={res.modularity:.4f} "
              f"iters={res.lpa_iterations}+{res.split_iterations}split "
              f"disconnected={res.disconnected_fraction}")
        out["detect"] = {"backend": res.backend, "device": res.device,
                         "communities": res.num_communities,
                         "modularity": res.modularity,
                         "disconnected_fraction": res.disconnected_fraction,
                         "lpa_iterations": res.lpa_iterations,
                         "split_iterations": res.split_iterations,
                         "timings": res.timings}
    return out


def _ingest_ooc(path: str, args, opts) -> dict:
    """--ooc: windowed store reads end to end, the full arrays never built
    (a file not yet in the store still pays its one parse inside
    ``open_graph``)."""
    import numpy as np

    from repro_torch.engine import EngineConfig
    from repro_torch.io.store import open_graph
    from repro_torch.partition.ooc import fit_out_of_core
    from repro_torch.partition.plan import parse_bytes
    from repro_torch.partition.slices import StoreEntrySource

    if args.no_cache:
        raise SystemExit("--ooc reads partition windows from the on-disk "
                         "store and cannot combine with --no-cache")
    budget = parse_bytes(args.memory_budget or "64MB")
    handle = open_graph(path, opts, fmt=args.format,
                        one_based=args.one_based, cache_dir=args.cache_dir,
                        force=args.force)
    s = handle.meta.get("stats", {})
    print(f"[ingest] {path}: store entry (key {handle.key})")
    print(f"  graph: n={handle.n} directed_edges={handle.num_edges} "
          f"d_avg={handle.num_edges / max(handle.n, 1):.1f}")
    _print_stats(args, s)

    run = fit_out_of_core(
        StoreEntrySource(handle),
        EngineConfig(backend=args.backend, device=args.device),
        memory_budget=budget,
        backend=None if args.backend == "auto" else args.backend)
    rate = _human_edges_per_s(handle.num_edges,
                              run.lpa_seconds + run.split_seconds)
    print(f"  ooc[{run.backend}]: |Gamma|={len(np.unique(run.labels))} "
          f"partitions={run.num_partitions} "
          f"peak={_human_bytes(run.peak_resident_bytes)} "
          f"(budget {_human_bytes(budget)}) "
          f"halo={run.halo_vertices} loads={run.partition_loads} "
          f"iters={run.lpa_iterations}+{run.split_iterations}split {rate}")
    if args.detect:
        print("  (skipping --detect: it needs the full graph in core; "
              "drop --ooc to run it)")
    return {"path": path, "key": handle.key, "n": handle.n,
            "directed_edges": handle.num_edges, "stats": s,
            "ooc": {"backend": run.backend, **run.stats(),
                    "communities": int(len(np.unique(run.labels))),
                    "plan_seconds": run.plan_seconds,
                    "lpa_seconds": run.lpa_seconds,
                    "split_seconds": run.split_seconds}}


def _print_stats(args, s: dict) -> None:
    if args.stats and s:
        print(f"  [§4.1] raw edges {s['raw_edges']} -> {s['edges']} "
              f"undirected (self-loops -{s['self_loops']}, duplicates "
              f"-{s['duplicates']})")
        print(f"  [§4.1] vertices {s['raw_vertices']} -> {s['vertices']} "
              f"(isolated {s['isolated_vertices']}, dropped off-LCC "
              f"{s['component_vertices_dropped']}); "
              f"weights: {'kept' if s['weighted'] else 'unit'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.ingest",
        description="Parse, preprocess, and store real graph files.")
    ap.add_argument("paths", nargs="*", help=".mtx / SNAP edge-list files")
    ap.add_argument("--format", choices=("mtx", "snap"),
                    help="override format sniffing")
    ap.add_argument("--one-based", action="store_true",
                    help="edge-list ids start at 1 (SNAP default is 0)")
    ap.add_argument("--stats", action="store_true",
                    help="print the §4.1 preprocessing report")
    ap.add_argument("--keep-self-loops", action="store_true")
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--keep-weights", action="store_true",
                    help="keep file weights (paper default is unit)")
    ap.add_argument("--largest-cc", action="store_true",
                    help="restrict to the largest connected component")
    ap.add_argument("--compact-ids", action="store_true",
                    help="dense-relabel the vertex ids that appear")
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the on-disk CSR store")
    ap.add_argument("--force", action="store_true",
                    help="re-ingest even on a store hit")
    ap.add_argument("--cache-dir", help="CSR store location "
                    "(default: $REPRO_GRAPH_CACHE or ~/.cache/repro/graphs)")
    ap.add_argument("--detect", action="store_true",
                    help="run one engine fit on the ingested graph")
    ap.add_argument("--device", default=None,
                    help="where --detect and --ooc run (default cuda; cpu "
                    "on request)")
    ap.add_argument("--ooc", action="store_true",
                    help="run an out-of-core partitioned detection over "
                         "the store entry (windowed reads, never the "
                         "full edge arrays)")
    ap.add_argument("--memory-budget", default=None,
                    help="resident edge-byte cap of --ooc, e.g. 64MB "
                         "(default 64MB)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--json", help="write per-file reports to this path")
    ap.add_argument("--list-cache", action="store_true",
                    help="list on-disk store entries and exit")
    args = ap.parse_args(argv)

    if args.list_cache:
        store = CsrStore(args.cache_dir)
        entries = store.entries()
        print(f"[ingest] {len(entries)} cached graphs in {store.root}")
        for e in entries:
            print(f"  {e['key']}  n={e.get('n')} m={e.get('num_edges')}  "
                  f"{e.get('source', '?')}  [{e.get('options', '')}]")
        return 0

    if not args.paths:
        ap.error("no input files (or use --list-cache)")
    reports = [ingest(p, args) for p in args.paths]
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(reports, fh, indent=2)
        print(f"[ingest] wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
