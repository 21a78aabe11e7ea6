"""Named dataset registry: one place to say which graph a name means.

Synthetic entries are builder callables; file entries are paths routed
through :func:`repro_torch.io.store.load_graph` (so they inherit the
parse-once CSR store).  Every consumer resolves names through the same
table.

    from repro_torch.io import datasets
    g = datasets.get("web_rmat")                     # built-in synthetic
    datasets.register_file("orkut", "com-orkut.mtx")  # local corpus file
    datasets.fetch("orkut", URL, SHA256)     # download + verify + register
    g, stats = datasets.get_with_stats("orkut")       # + §4.1 stats

The built-in entries are small analogues of the paper's Table-1 graph
classes, built by :mod:`repro_torch.graphgen` as the JAX package's
registry builds them (same seeds, same graphs); the real SuiteSparse
graphs drop in as file entries under the same call sites.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Callable

from repro_torch.io.preprocess import PreprocessOptions


@dataclasses.dataclass(frozen=True)
class DatasetEntry:
    """One named dataset: a synthetic builder or a graph file."""
    name: str
    kind: str                      # "synthetic" | "file"
    description: str = ""          # Table-1 class, e.g. "web (indochina-2004)"
    builder: Callable | None = None          # kind == "synthetic"
    path: str | None = None                  # kind == "file"
    options: PreprocessOptions | None = None  # file preprocessing knobs
    load_kwargs: dict = dataclasses.field(default_factory=dict)


_REGISTRY: dict[str, DatasetEntry] = {}
_GRAPH_CACHE: dict[str, object] = {}  # name -> built Graph (per process)


def register(name: str, builder: Callable, *, description: str = "",
             overwrite: bool = False) -> DatasetEntry:
    """Register a synthetic dataset (zero-arg builder -> Graph)."""
    return _put(DatasetEntry(name=name, kind="synthetic", builder=builder,
                             description=description), overwrite)


def register_file(name: str, path, *, description: str = "",
                  options: PreprocessOptions | None = None,
                  overwrite: bool = False, **load_kwargs) -> DatasetEntry:
    """Register a graph file (``.mtx`` / SNAP edge list) by path.

    ``load_kwargs`` pass through to :func:`repro_torch.io.store.load_graph`
    (``fmt``, ``one_based``, ``n``, ``cache_dir`` ...).  The file only
    needs to exist at first ``get``, not at registration.
    """
    return _put(DatasetEntry(name=name, kind="file", path=str(path),
                             description=description, options=options,
                             load_kwargs=dict(load_kwargs)), overwrite)


def _put(entry: DatasetEntry, overwrite: bool) -> DatasetEntry:
    if not overwrite and entry.name in _REGISTRY:
        raise ValueError(f"dataset {entry.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[entry.name] = entry
    _GRAPH_CACHE.pop(entry.name, None)
    return entry


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)
    _GRAPH_CACHE.pop(name, None)


def names() -> list[str]:
    return sorted(_REGISTRY)


def entry(name: str) -> DatasetEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; registered: "
                       f"{', '.join(names()) or '<none>'}") from None


def get(name: str):
    """Resolve a name to its built :class:`Graph` (memoized per process).

    File entries additionally hit the on-disk CSR store, so the first
    ``get`` in a *process* may still be instant if another process
    already ingested the file.
    """
    return get_with_stats(name)[0]


def get_with_stats(name: str):
    """(Graph, preprocessing-stats dict or None for synthetics)."""
    e = entry(name)
    cached = _GRAPH_CACHE.get(name)
    if cached is not None:
        return cached
    if e.kind == "synthetic":
        out = (e.builder(), None)
    else:
        from repro_torch.io.store import load_graph
        if not Path(e.path).is_file():
            raise FileNotFoundError(
                f"dataset {name!r} points at missing file {e.path} — "
                "download it first (see README 'Loading real graphs')")
        graph, report = load_graph(e.path, e.options, return_report=True,
                                   **e.load_kwargs)
        out = (graph, report.stats)
    _GRAPH_CACHE[name] = out
    return out


def clear_graph_cache() -> None:
    """Drop memoized graphs (tests; registrations stay)."""
    _GRAPH_CACHE.clear()


# --- corpus downloads -------------------------------------------------------

_DOWNLOAD_BLOCK = 4 << 20


def download_dir() -> Path:
    """Where fetched corpus files land (sibling of the CSR store)."""
    from repro_torch.io.store import default_cache_dir
    return default_cache_dir().parent / "downloads"


def fetch(name: str, url: str, sha256: str, *, description: str = "",
          filename: str | None = None, cache_dir=None,
          options: PreprocessOptions | None = None,
          overwrite: bool = False, timeout: float = 60.0,
          **load_kwargs) -> DatasetEntry:
    """Download a corpus file, verify its checksum, register it.

    The SuiteSparse/SNAP onboarding path: one call turns a URL +
    published sha256 into a named dataset every consumer (the ingest
    CLI, ``Engine.fit`` through ``datasets.get``) can resolve.  The
    download is atomic (temp file + rename) and idempotent — a file
    already present with the right checksum is never re-fetched; a
    present file with the *wrong* checksum is treated as a damaged
    partial and re-downloaded.  A checksum mismatch on the fresh bytes
    raises and leaves nothing behind.  ``file://`` URLs work (the tests
    use nothing else).  Gzipped payloads can register as-is —
    the chunked readers decompress transparently.  ``timeout`` guards
    every socket operation (a mirror that stalls mid-transfer raises
    instead of hanging the caller).
    """
    from repro_torch.io.store import file_content_hash
    dest_dir = Path(cache_dir) if cache_dir is not None else download_dir()
    dest = dest_dir / (filename or os.path.basename(
        urllib.parse.urlparse(url).path) or name)
    if not dest.is_file() or file_content_hash(dest) != sha256.lower():
        dest_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dest_dir, prefix=f".{dest.name}-")
        try:
            h = hashlib.sha256()
            with os.fdopen(fd, "wb") as out, \
                    urllib.request.urlopen(url, timeout=timeout) as resp:
                while True:
                    block = resp.read(_DOWNLOAD_BLOCK)
                    if not block:
                        break
                    h.update(block)
                    out.write(block)
            if h.hexdigest() != sha256.lower():
                raise ValueError(
                    f"checksum mismatch for {url}: expected {sha256}, "
                    f"got {h.hexdigest()} — upstream changed or the "
                    "transfer was corrupted; nothing was registered")
            os.replace(tmp, dest)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    return register_file(name, dest, description=description,
                         options=options, overwrite=overwrite,
                         **load_kwargs)


# --- built-in synthetic suite (the paper's Table-1 class analogues) --------

def _register_builtins() -> None:
    from repro_torch import graphgen as gg
    builtin = {
        "web_rmat": (lambda: gg.rmat(12, 12, seed=1),
                     "web (indochina-2004)"),
        "social_rmat": (lambda: gg.rmat(11, 24, seed=2),
                        "social (com-Orkut)"),
        "road_grid": (lambda: gg.grid2d(64), "road (asia_osm)"),
        "kmer_sparse": (lambda: gg.erdos_renyi(6000, 2.2, seed=3),
                        "protein k-mer (kmer_A2a)"),
        "planted": (lambda: gg.planted_partition(16, 64, 0.25, 0.002,
                                                 seed=4)[0],
                    "planted partition (quality ref)"),
    }
    for name, (builder, desc) in builtin.items():
        if name not in _REGISTRY:
            register(name, builder, description=desc)


_register_builtins()
