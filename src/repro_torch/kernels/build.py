"""Build and load the hand-written CUDA kernels (``csrc/``).

The kernels are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
ctypes.  Each source compiles in its own ``nvcc`` process, all started
together.  The output goes to ``build/kernels/<hash of sources and
flags>/`` under the repository root, so an edited source rebuilds and an
unchanged one loads the existing library.
Importing this module needs no CUDA toolkit; only :func:`load_library`
does.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("label_argmax.cu", "min_label.cu", "fused_move.cu",
           "fused_split.cu", "flash_attention.cu")
HEADERS = ("lpa_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "liblpa_kernels.so"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argument types; every pointer and the stream are
# c_void_p, every entry point returns the cudaError_t of its launch.
SIGNATURES = {
    "lpa_label_argmax": (_P, _P, _P, _P, _LL, _I, _I, _P, _P, _P, _P),
    "lpa_min_label": (_P, _P, _P, _P, _LL, _I, _P, _P),
    "lpa_fused_move": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P,
                       _P, _P),
    "lpa_fused_split": (_P, _P, _P, _P, _P, _I, _LL, _I, _P, _P),
    # q, k, v, out; B, H, K, Sq, Skv, hd, causal, dtype code; stream
    "attn_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P),
}

_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_root() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + \
            [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return found


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
# a kernel's template arguments (ints and bools): _kernelILi4ELb1EE
_TEMPLATE = re.compile(r"_kernelI((?:L[ib]\d+E)+)E")
_TEMPLATE_ARG = re.compile(r"L([ib])(\d+)E")
# ptxas' note that it ran a kernel's wgmma one at a time, and why.
_SERIALIZED = re.compile(r"wgmma\.mma_async instructions are serialized "
                         r"(.*?) in the function '([^']+)'")
_KERNELS = ("label_argmax_narrow", "label_argmax_wide", "label_argmax",
            "min_label_narrow", "min_label_wide", "fused_move_narrow",
            "fused_move_wide", "fused_move", "fused_split_narrow",
            "fused_split_wide", "flash_wgmma", "flash_fma")


def _kernel_name(mangled: str) -> str:
    """``name`` or, for a template instance, ``name<4>`` /
    ``name<4, true>``."""
    name = next((k for k in _KERNELS if f"{k}_kernel" in mangled), mangled)
    t = _TEMPLATE.search(mangled)
    if t is None:
        return name
    args = [v if kind == "i" else ("true" if v == "1" else "false")
            for kind, v in _TEMPLATE_ARG.findall(t.group(1))]
    return f"{name}<{', '.join(args)}>"


def _resources(ptxas_log: str) -> dict:
    """Registers, spill bytes and wgmma serialisation (its reason) per
    kernel from ``-Xptxas -v`` output."""
    out: dict = {}
    current = None
    for line in ptxas_log.splitlines():
        m = _SERIALIZED.search(line)
        if m:
            out.setdefault(_kernel_name(m.group(2)), {})[
                "wgmma_serialized"] = m.group(1)
            continue
        m = _ENTRY.search(line)
        if m:
            current = _kernel_name(m.group(1))
            out.setdefault(current, {})
            continue
        if current is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[current]["spill_store_bytes"] = int(m.group(1))
            out[current]["spill_load_bytes"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


def build() -> tuple[Path, dict]:
    """Compile the library if needed; returns (path, build info)."""
    final = build_root() / source_hash()
    lib = final / LIB_NAME
    if lib.exists():
        info = json.loads((final / "build.json").read_text())
        return lib, {**info, "cached": True}
    final.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=final.parent, prefix=".build-"))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / (Path(src).stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _obj, p in procs:
            out, _ = p.communicate()
            logs.append(out)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(obj) for _s, obj, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        info = {"seconds": time.perf_counter() - t0, "nvcc": nvcc,
                "flags": list(NVCC_FLAGS), "dir": str(final),
                "resources": _resources("\n".join(logs))}
        (tmp / "build.json").write_text(json.dumps(info, indent=1))
        try:
            tmp.rename(final)
        except OSError:      # another process finished the same build first
            if not (final / LIB_NAME).exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib, {**info, "cached": False}


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if it cannot be."""
    global _LIB
    if _LIB is None:
        path, info = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _LIB = lib
    return _LIB
