"""serenedb_tpu_torch — the PyTorch/CUDA port of serenedb_tpu for NVIDIA Hopper.

Each module keeps the path and names of its counterpart in `serenedb_tpu`,
so a reader finds one from the other. Host code (analysis, query parsing,
index build, WAND planning, the SQL front end and host executor) comes
over as copies that change only what their first docstring line says;
device work runs as hand-written CUDA kernels for `sm_90a` (`ops/csrc/`),
each with a plain PyTorch version beside it (`ops/bm25_kernels.py`,
`ops/agg_kernels.py`) that the CPU tests hold against the JAX package.

This package imports `torch` and numpy, never `jax` and nothing of
`serenedb_tpu`. Entry points run on `cuda:0` unless the caller passes
`device="cpu"`; with no card and no explicit CPU request they raise
(`device.resolve_device`).

Ported so far: BM25/TFIDF/LM top-k search through
`search.searcher.SegmentSearcher.topk_batch` (dense and packed regimes,
and the batched ragged path with the paged posting pool), SQL analytics,
top-N, joins, and search and vector search through
`engine.Database(device=...).connect().execute`, and serving: the ES API
and the PG wire behind `server.frontdoor.FrontDoor`, started by
`python -m serenedb_tpu_torch.serened`, durable storage
(`Database(path)`: catalog, parquet snapshots, the WAL and recovery;
it needs pyarrow), the file sources `read_csv` / `read_parquet`, and the
native C++ indexer (`native/`, built with g++ at first use), and the
device mesh (`parallel/mesh.py`: the host's cards, or a virtual mesh of
logical devices over one, with the `serene_mesh` branches and the
reference's sharded builders on `ops/csrc/mesh.cu`).
"""

__version__ = "0.1.0"


def build_id() -> str:
    """Version + git revision (copied from serenedb_tpu's `build_id`). The
    revision is taken only when this package lives inside the git
    checkout; 'unknown' otherwise."""
    import os
    import subprocess
    rev = "unknown"
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=5, cwd=pkg_root)
        if top.returncode == 0 and \
                os.path.realpath(top.stdout.strip()) == \
                os.path.realpath(pkg_root):
            r = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=5, cwd=pkg_root)
            if r.returncode == 0 and r.stdout.strip():
                rev = r.stdout.strip()
    except Exception:  # noqa: BLE001 — build id must never break boot
        pass
    return f"serenedb-tpu-torch {__version__} ({rev})"
