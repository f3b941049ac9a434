"""The harness finds a new configuration, traffic mix and metric from
their files and their entries in BENCHMARK.json alone, with no edit to a
file the benchmark already has."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

NEW_MIX = {"family": "sql", "clients": 2, "loop": "closed", "order": "cycle",
           "warm_each": True, "warm_per_client": 0,
           "source": "ClickBench queries.sql line 1",
           "statements": ["SELECT COUNT(*) FROM hits;"]}
NEW_METRIC = '''"""Statements sent in the window."""


def read(run):
    return float(len(run.records))
'''
DRIVER = '''
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
from portbench import harness
assert str(harness.ROOT) == sys.argv[1], harness.ROOT
out = harness.run("small_hits.line1", 9, 1.0, False, time.perf_counter(),
                  device="cpu", overrides={"settings": {
                      "serene_device": "gpu"}})
print(json.dumps(out))
'''


def test_a_new_cell_from_its_files(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "clickbench_hits.json").read_text())
    cfg["name"], cfg["rows"] = "small_hits", 50_000
    (pb / "configs" / "small_hits.json").write_text(json.dumps(cfg))
    for part in ("gen", "reference"):
        shutil.copy(pb / part / "clickbench_hits.py",
                    pb / part / "small_hits.py")
    (pb / "traffic" / "line1.json").write_text(json.dumps(NEW_MIX))
    (pb / "metrics" / "stmts_sent.line1.py").write_text(NEW_METRIC)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small_hits", "source": "x",
                             "file": "portbench/configs/small_hits.json",
                             "reduced": ["rows"], "why": "a test"})
    bench["workloads"].append({"name": "small_hits.line1",
                               "config": "small_hits", "traffic": "line1",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "stmts_sent.line1", "unit": "stmt",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["small_hits.line1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run([sys.executable, "-c", DRIVER, str(tmp_path),
                        str(HERE.parent)], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["stmts_sent.line1"]["value"] > 0
    assert "setup_s" in out["metrics"] and "sql_qps" not in out["metrics"]
