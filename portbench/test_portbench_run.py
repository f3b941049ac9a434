"""Whole runs of every cell on the CPU at small sizes, with the kernels'
plain versions: the harness drives the port's server, the load process
and the reference as on the card (only the look for a card is skipped),
and `correct` comes out true. Then the timed path is broken underneath,
once for each fault a cell can have, and `correct` comes out false."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from portbench import harness

HERE = Path(__file__).resolve().parent
SMALL = {
    "clickbench_hits": {"rows": 120_000},
    "msmarco_bm25": {"passages": 4_000, "vocabulary": 6_000,
                     "queries": 400},
}
CELLS = [w["name"] for w in harness.bench_file()["workloads"]]


def run(workload, trace=False, seed=2**31 + 5, seconds=2.0):
    cell = harness.Cell.find(harness.bench_file(), workload)
    over = dict(SMALL[cell.config["name"]],
                settings={"serene_device": "gpu",
                          "serene_device_chunk_rows": 32_768})
    return harness.run(workload, seed, seconds, trace, time.perf_counter(),
                       device="cpu", overrides=over)


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_runs_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    e2e = {m["name"] for m in harness.bench_file()["end_to_end"]
           if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == e2e
    assert list(out)[-1] == "checks"
    assert harness.forbidden_modules() == []


def test_a_traced_run_reads_its_per_layer_metrics():
    out = run("hits_100m.agg_mix", trace=True)
    assert out["correct"]
    assert {"launches_per_stmt.sql", "upload_bytes_per_stmt.sql",
            "sql_p50_ms"} <= set(out["metrics"])
    # no device timeline on the CPU: the device metrics stay silent
    assert "device_idle_pct.sql" not in out["metrics"]
    assert out["breakdown"]["idle_gaps"]


def _alter_agg(monkeypatch):
    from serenedb_tpu_torch.exec import device_agg
    orig = device_agg._chunked_dispatch

    def altered(*a, **kw):
        out = list(orig(*a, **kw))
        out[0] = out[0] + 1
        return tuple(out)
    monkeypatch.setattr(device_agg, "_chunked_dispatch", altered)


def _half_rows(monkeypatch):
    from serenedb_tpu_torch.exec import device_agg
    orig = device_agg._chunked_dispatch

    def half(run_chunk, n_tiles, chunk_tiles, combines):
        def every_other(start, stop):
            outs = run_chunk(start, stop)
            if (start // chunk_tiles) % 2:
                return tuple(np.zeros_like(o) if c == "sum" else o
                             for o, c in zip(outs, combines))
            return outs
        return orig(every_other, n_tiles, chunk_tiles, combines)
    monkeypatch.setattr(device_agg, "_chunked_dispatch", half)


def _alter_search(monkeypatch):
    from serenedb_tpu_torch.search import batcher
    orig = batcher.batched_topk

    def altered(*a, **kw):
        (scores, docs), stats = orig(*a, **kw)
        docs = np.array(docs, copy=True)
        if len(docs) > 1:
            docs[[0, 1]] = docs[[1, 0]]
        return (scores, docs), stats
    monkeypatch.setattr(batcher, "batched_topk", altered)


def _half_batch(monkeypatch):
    from serenedb_tpu_torch.search import searcher
    for cls in (searcher.SegmentSearcher, searcher.MultiSearcher):
        orig = cls.topk_batch

        def half(self, nodes, *a, _orig=orig, **kw):
            keep = max(1, len(nodes) // 2)
            outs = _orig(self, nodes[:keep], *a, **kw)
            return list(outs) + [outs[0]] * (len(nodes) - keep)
        monkeypatch.setattr(cls, "topk_batch", half)


FAULTS = [("hits_100m.agg_mix", _alter_agg),
          ("hits_100m.agg_mix", _half_rows),
          ("msmarco_1m.search_batched", _alter_search),
          ("msmarco_1m.search_batched", _half_batch)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run(workload)
    assert not out["correct"], out["checks"]


def test_no_card_no_result(no_card):
    """Without a card the command exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "hits_100m.agg_mix", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=HERE.parent, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def test_the_benchmark_alone_is_no_result(tmp_path, no_card):
    """In a directory holding only BENCHMARK.json and the files under
    `paths`, the command exits non-zero and prints no result."""
    import shutil
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "hits_100m.agg_mix", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and not p.stdout.strip()
