"""Build and load the port's CUDA kernels.

Each source under `csrc/` has a plain C interface and compiles with
`nvcc` into its own shared library under `serenedb_tpu_torch/_build/`, at
first use, named by a hash of the source and flags so a changed source
never loads a stale build. The libraries load with `ctypes`: every pointer
and the stream travel as `c_void_p`. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = {"bm25": CSRC / "bm25.cu", "agg": CSRC / "agg.cu",
           "topn": CSRC / "topn.cu", "join": CSRC / "join.cu",
           "vector": CSRC / "vector.cu", "pool": CSRC / "pool.cu",
           "merge": CSRC / "merge.cu", "mesh": CSRC / "mesh.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              # keep each a*b+c as two rounded operations, as the plain
              # versions and the reference compute them
              "-fmad=false", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry, by library
SIGNATURES = {
    "bm25": {
        "bm25_accumulate_rows": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _L, _I, _P, _P, _L, _I, _F, _F, _F, _P],
        "bm25_accumulate_tail": [_P, _P, _P, _P, _P, _L, _I, _P, _P, _P, _L,
                                 _I, _F, _F, _F, _P],
        "build_dense_rows": [_I, _P, _P, _P, _P, _P, _P, _L, _P, _P, _L, _I,
                             _F, _F, _F, _P],
        "build_dense_tail": [_P, _P, _P, _L, _P, _P, _L, _I, _F, _F, _F, _P],
        "topk_bytes": [_L, _L, _I, _I],
        "topk_rows": [_P, _L, _L, _P, _I, _P, _I, _I, _P, _P],
        "contrib_flat": [_P, _P, _P, _P, _L, _I, _F, _F, _F, _P, _P],
        "match_bitmap": [_P, _P, _P, _P, _L, _P, _P, _L, _P, _L, _L, _P, _P],
    },
    "agg": {
        "agg_scan": [_P, _I, _L, _L, _L, _L, _I, _P, _P],
        "agg_fold": [_P, _L, _L, _P, _P],
    },
    "topn": {
        "topn_load": [],
        "topn_bytes": [_L, _L],
        "topn_scan": [_P, _L, _L, _P, _L, _P],
        "chain_bytes": [_L, _L, _L],
        "chain_topn": [_P, _P],
    },
    "join": {
        "join_probe": [_P, _I, _L, _P, _L, _L, _L, _P, _L, _P],
    },
    "vector": {
        "ivf_probe": [_P] * 7 + [_I] * 5 + [_L] + [_I] * 2 +
                     [_P, _L, _P, _P, _P],
        "probe_bytes": [_I, _I, _I, _L, _I],
        "maxsim": [_P] * 7 + [_L] + [_I] * 5 +
                  [_P, _L, _P, _L, _P, _L, _P, _P, _P],
        "kmeans_assign": [_P] * 3 + [_L, _I, _I] + [_P] * 4,
        "kmeans_bytes": [_L, _I, _I],
        "kmeans_update": [_P] * 3 + [_L, _I, _I] + [_P] * 3,
        "select_cap": [_L, _L, _L, _L, _I, _I],
    },
    "pool": {
        "pool_score": [_P] * 8 + [_L, _L, _I, _L, _I, _F, _F, _F] +
                      [_P, _P, _P, _I, _P, _L, _P, _L, _P, _P, _I, _I, _P],
    },
    "merge": {
        "merge_topk": [_P, _P, _L, _L, _L, _I, _P, _L, _P, _L, _P, _P, _P],
    },
    "mesh": {
        "mesh_combine": [_P, _L, _L, _I, _I, _I, _P, _P],
        "mesh_agg_partials": [_P, _P, _L, _L, _L, _P, _P],
        "score_bytes": [_L, _L],
        "mesh_score_blocks": [_P] * 6 + [_L, _I, _L, _I, _F, _F, _F] +
                             [_P, _P, _P],
    },
}

#: entries that return a size (bytes, or keys for select_cap), not a CUDA
#: error
SIZE_ENTRIES = {"topn_bytes", "chain_bytes", "kmeans_bytes", "topk_bytes",
                "select_cap", "probe_bytes", "score_bytes"}
#: the entry each library runs once, right after it loads (kernel
#: attributes), by library
LOAD_HOOKS = {"topn": "topn_load"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": float, "log": str} for builds made in this process
BUILD_LOG: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> Path:
    src = SOURCES[name]
    # the shared headers are part of every source
    h = hashlib.sha256(src.read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))) +
        " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": secs, "log": proc.stdout + proc.stderr}
    from ..obs.device import note_kernel_build
    note_kernel_build(secs * 1e9)
    return out


def build_all() -> dict[str, dict]:
    """Compile every source at once, one nvcc each; return BUILD_LOG."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        for fut in [ex.submit(_compile, n) for n in SOURCES]:
            fut.result()
    return dict(BUILD_LOG)


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = _L if fn in SIZE_ENTRIES else ctypes.c_int
            if name in LOAD_HOOKS:
                check(getattr(lib, LOAD_HOOKS[name])(), LOAD_HOOKS[name])
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
