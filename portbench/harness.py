"""One run of one cell: the port's server started over the cell's data,
the cell's load sent from a client process for `--seconds`, every answer
held to the plain reference, one JSON line printed.

What a cell is made of is found by name from `BENCHMARK.json`: the
configuration's `file`, `gen/<config>.py`, `reference/<config>.py`,
`traffic/<traffic>.json` and a reader `metrics/<metric>.py` for every
metric the cell reports. Nothing here names a cell, a configuration, a
mix or a metric.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import re
import select
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "serenedb_tpu")
#: seconds between the load's warm-up and the window's start
LEAD_S = 0.25
#: the traced slice: from this share of the window, for this share of it
SLICE_AT, SLICE_SHARE, SLICE_MAX_S = 0.3, 0.4, 8.0


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


class RunError(RuntimeError):
    """A run that cannot give a result (exit code `code`)."""

    def __init__(self, msg: str, code: int = 1):
        super().__init__(msg)
        self.code = code


def load_module(path: Path, name: str):
    """The module at `path`, registered as `name` (a metric's file name
    holds dots, so it is loaded by path, not imported by name)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def bench_file() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of BENCHMARK.json with everything it names."""
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # traffic/<mix>.json
    gen: object
    reference: object
    end_to_end: list      # metric entries this cell reports
    per_layer: list

    @staticmethod
    def find(bench: dict, workload: str) -> "Cell":
        wl = [w for w in bench["workloads"] if w["name"] == workload]
        if not wl:
            raise RunError(f"no workload {workload!r} in BENCHMARK.json", 2)
        wl = wl[0]
        entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
        with open(ROOT / entry["file"]) as f:
            config = json.load(f)
        with open(HERE / "traffic" / f"{wl['traffic']}.json") as f:
            traffic = json.load(f)
        name = wl["config"]
        gen = load_module(HERE / "gen" / f"{name}.py", f"portbench_gen_{name}")
        ref = load_module(HERE / "reference" / f"{name}.py",
                          f"portbench_ref_{name}")

        def mine(m):
            return workload in m.get("workloads", [workload])
        return Cell(workload, int(wl["chips"]), config, traffic, gen, ref,
                    [m for m in bench["end_to_end"] if mine(m)],
                    [m for m in bench["per_layer"] if mine(m)])


def statements(cell: Cell, data: dict) -> list[str]:
    """The mix's statements: its list, or its template over a pool that
    the generator made."""
    t = cell.traffic
    if "statements" in t:
        return list(t["statements"])
    return [t["template"].replace("{q}", q) for q in data["pools"][t["pool"]]]


def orders(cell: Cell, n_stmts: int, seed: int) -> list[list[int]]:
    """Each client's sequence of statement indices. Every seed gives the
    clients the same sequences, so every seed does the same work; the seed
    only turns which client runs which of them. `cycle`: client c runs the
    list from statement c on (the clients spread evenly over it); `deal`:
    client c takes every `clients`-th statement from statement c on."""
    t = cell.traffic
    clients = int(t["clients"])
    turn = int(np.random.default_rng([int(seed), 7]).integers(clients))
    if t["order"] == "cycle":
        seqs = [[(c + j) % n_stmts for j in range(n_stmts)]
                for c in range(clients)]
    elif t["order"] == "deal":
        seqs = [list(range(c, n_stmts, clients)) for c in range(clients)]
    else:
        raise RunError(f"unknown order {t['order']!r}")
    return seqs[turn:] + seqs[:turn]


def columns_read(cell: Cell, stmts: list) -> set | None:
    """The configuration's columns that some statement names, or its
    first where none does (None: the configuration has no column list, so
    all of it)."""
    cols = cell.config.get("columns")
    if cols is None:
        return None
    found = {c for c in cols
             if any(re.search(rf"\b{re.escape(c)}\b", s) for s in stmts)}
    return found or {next(iter(cols))}    # a table has at least a column


# ---------------------------------------------------------------- the port

def port_tables(db, tables: dict) -> None:
    """The generated tables as the port's in-memory tables."""
    from serenedb_tpu_torch.columnar import dtypes as dt
    from serenedb_tpu_torch.columnar.column import Batch, Column
    from serenedb_tpu_torch.exec.tables import MemTable
    for tname, cols in tables.items():
        names, columns = [], []
        for cname, spec in cols.items():
            columns.append(Column(dt.type_from_name(spec["type"]),
                                  spec["data"], None, spec["dictionary"]))
            names.append(cname)
        db.schemas["main"].tables[tname] = MemTable(tname, Batch(names,
                                                                 columns))


@dataclass
class Counters:
    launches: dict
    uploads: dict
    batch_queries: int
    batch_dispatches: int

    @staticmethod
    def read() -> "Counters":
        from serenedb_tpu_torch.device import LAUNCHES, UPLOADS
        from serenedb_tpu_torch.utils import metrics
        return Counters(LAUNCHES.snapshot(), UPLOADS.snapshot(),
                        int(metrics.SEARCH_BATCH_QUERIES.value),
                        int(metrics.SEARCH_BATCH_DISPATCHES.value))

    def minus(self, other: "Counters") -> "Counters":
        def d(a, b):
            return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}
        return Counters(d(self.launches, other.launches),
                        d(self.uploads, other.uploads),
                        self.batch_queries - other.batch_queries,
                        self.batch_dispatches - other.batch_dispatches)


# ---------------------------------------------------------------- a run

@dataclass
class Run:
    """What the metric readers read (`metrics/<name>.py`: read(run))."""
    cell: Cell
    seed: int
    seconds: float
    setup_s: float
    t0: float
    t1: float
    records: list              # (conn, idx, sent, answered, error, rows)
    statements: list
    counters: Counters         # over every statement sent in the window
    reference: object
    slice: object = None       # trace.Slice in a traced run

    def completed(self) -> list:
        """Statements answered without error inside the window."""
        return [r for r in self.records if r[3] <= self.t1 and not r[4]]

    def latencies_ms(self) -> np.ndarray:
        """The latency of every statement sent in the window, answered
        before its end or after it (a long statement still running at the
        end is in the tail, not left out of it); a failed one as
        infinite, so it misses any limit."""
        return np.asarray([(r[3] - r[2]) * 1e3 if not r[4] else np.inf
                           for r in self.records])

    def rate(self) -> float:
        return len(self.completed()) / (self.t1 - self.t0)

    def percentile_ms(self, q: float):
        lat = np.sort(self.latencies_ms())
        if not len(lat):
            return None
        return float(lat[min(len(lat) - 1, int(np.ceil(q / 100 * len(lat))) - 1)])

    def timeline(self, step: float) -> list:
        """Statements answered without error in each `step` seconds of
        the window, from its start."""
        bins = int(np.ceil((self.t1 - self.t0) / step))
        ends = [r[3] for r in self.completed() if r[3] >= self.t0]
        return np.bincount(((np.asarray(ends) - self.t0) // step).astype(
            np.int64), minlength=bins).tolist()

    def slice_shares(self) -> list:
        """(statement, share) for every statement answered without error
        whose time overlaps the traced slice: the share of its time, send
        to answer, that lies inside the slice. A statement's work taken as
        spread evenly over its time, the shares' work is the work the
        slice's device time did, straddlers at its ends included."""
        if self.slice is None:
            return []
        out = []
        for r in self.records:
            if r[4]:
                continue
            inside = min(r[3], self.slice.end) - max(r[2], self.slice.start)
            if inside > 0:
                out.append((self.statements[r[1]], inside / (r[3] - r[2])))
        return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None, overrides: dict | None = None) -> dict:
    """One run; returns the result line. `device` and `overrides`
    (configuration keys replaced, `settings` merged) exist for the CPU
    tests: a run from the command line takes neither and needs the
    card."""
    import torch
    cell = Cell.find(bench_file(), workload)
    if overrides:
        cell.config = dict(cell.config, **{
            k: v for k, v in overrides.items() if k != "settings"})
        cell.config["settings"] = dict(cell.config.get("settings", {}),
                                       **overrides.get("settings", {}))
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card", 3)
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"{cell.name} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} present", 3)
        device = torch.device("cuda:0")
    device = torch.device(device)
    on_card = device.type == "cuda"

    from serenedb_tpu_torch.engine import Database
    from serenedb_tpu_torch.server.frontdoor import FrontDoor
    from serenedb_tpu_torch.server.pgwire import PgServer
    from serenedb_tpu_torch.utils.config import REGISTRY as settings

    stmts_cfg = cell.traffic.get("statements")
    t = time.perf_counter()
    log(f"started, {t - t_start:.3f} s")
    data = cell.gen.generate(seed, cell.config, columns_read(
        cell, stmts_cfg) if stmts_cfg else None, device)
    stmts = statements(cell, data)
    t = _phase("generate", t)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    for key, value in cell.config.get("settings", {}).items():
        settings.set_global(key, value)
    db = Database(device=device)
    port_tables(db, data["tables"])
    conn = db.connect()
    t = _phase("load", t)
    for sql in cell.config.get("setup_sql", []):
        conn.execute(sql)
    t = _phase("setup_sql", t)
    pg = PgServer(db, "127.0.0.1", 0)
    front = FrontDoor(db, http_port=0, pg=pg)
    front.start()
    sl, client = None, None
    try:
        client = Client()
        client.send({"port": pg.port, "statements": stmts,
                     "orders": orders(cell, len(stmts), seed),
                     "warm_each": bool(cell.traffic["warm_each"]),
                     "warm": int(cell.traffic["warm_per_client"])})
        _, warm_errors = client.recv(1200)
        if warm_errors:
            raise RunError(f"warm-up statements failed: {warm_errors[:3]}")
        t = _phase("warm", t)
        if trace and on_card:
            from portbench import trace as tr
            tr.warm_profiler(device)
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter() + LEAD_S
        t1 = t0 + seconds
        before = Counters.read()
        host = HostLoad()
        client.send(["go", t0, t1])
        if trace:
            from portbench import trace as tr
            length = min(SLICE_MAX_S, SLICE_SHARE * seconds)
            if on_card:
                sl = tr.profile_slice(t0 + SLICE_AT * seconds, length, device)
            else:
                sl = _host_slice(t0 + SLICE_AT * seconds, length)
        _, records = client.recv(seconds + 600)
        host.stop()
        counters = Counters.read().minus(before)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    finally:
        front.stop()
        if client is not None:
            client.close()
    kind_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    setup_s = t0 - t_start
    del conn, db, front, pg
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = _phase("window and its trailing statements", t0)
    ref = cell.reference.Reference(data, cell.config)
    r = Run(cell, seed, seconds, setup_s, t0, t1, records, stmts, counters,
            ref, sl)
    log(f"host in the window: {host}")
    log("answered a 5 s of the window: " + " ".join(
        str(n) for n in r.timeline(5.0)))
    out = _result(r, trace, kind_name, peak, on_card)
    _phase("reference and metrics", t)
    return out


class HostLoad:
    """What the host did around the window, for the log: the machine's
    CPU time by kind (steal: taken by other guests), this process's own
    CPU time and that of the load's process (known once it has ended),
    and this process's garbage collector's pauses by generation."""

    def __init__(self):
        self.gc_s, self.gc_n, self._gc_t = [0.0] * 3, [0] * 3, 0.0
        gc.callbacks.append(self._gc)
        self.stat0, self.cpu0 = _proc_stat(), os.times()
        self.wall0 = time.perf_counter()

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            g = info["generation"]
            self.gc_n[g] += 1
            self.gc_s[g] += time.perf_counter() - self._gc_t

    def stop(self) -> None:
        gc.callbacks.remove(self._gc)
        self.stat1, self.cpu1 = _proc_stat(), os.times()
        self.wall1 = time.perf_counter()

    def __str__(self) -> str:
        wall = self.wall1 - self.wall0
        own = (self.cpu1.user + self.cpu1.system
               - self.cpu0.user - self.cpu0.system)
        load = os.times()
        load = (load.children_user + load.children_system
                - self.cpu0.children_user - self.cpu0.children_system)
        out = (f"{wall:.1f} s, server CPU {own:.1f} s, load process CPU "
               f"{load:.1f} s")
        d = [b - a for a, b in zip(self.stat0 or [], self.stat1 or [])]
        total = sum(d)
        if total <= 0:
            out += ", the machine's CPU times not shown (/proc/stat still)"
        else:
            d += [0] * 8
            out += ", machine " + ", ".join(
                f"{name} {100 * d[i] / total:.1f} %" for i, name in
                ((0, "user"), (2, "system"), (3, "idle"), (4, "iowait"),
                 (7, "steal")))
        return out + (f"; gc (gen 0/1/2) {self.gc_n} in "
                      f"{[round(x, 3) for x in self.gc_s]} s")


def _proc_stat() -> list | None:
    """The machine's CPU times (user, nice, system, idle, iowait, irq,
    softirq, steal, ...) in clock ticks, where the system shows them."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None


def _phase(name: str, since: float) -> float:
    now = time.perf_counter()
    log(f"{name} {now - since:.3f} s")
    return now


class Client:
    """The load's process (`python -m portbench.load`), spoken to in JSON
    lines on its standard input and output."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.load"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def send(self, msg) -> None:
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def recv(self, timeout: float):
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            raise RunError("the load process ended or sent nothing in "
                           f"{timeout:.0f} s (exit code {self.proc.poll()})")
        return json.loads(line)

    def close(self) -> None:
        for f in (self.proc.stdin, self.proc.stdout):
            f.close()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _host_slice(start_at: float, length: float):
    """A slice with no device timeline (the CPU tests): the host's
    threads sampled only."""
    from portbench import trace as tr
    now = time.perf_counter()
    if now < start_at:
        time.sleep(start_at - now)
    sampler = tr.HostSampler()
    sampler.start()
    t_mark = time.perf_counter()
    time.sleep(length)
    t_end = time.perf_counter()
    sampler.stop()
    return tr.Slice(t_mark, t_end, samples=sampler.samples)


def _reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


def _result(r: Run, trace: bool, kind: str, peak: int,
            on_card: bool) -> dict:
    answers = [(rec[1], rec[5]) for rec in r.records if not rec[4]]
    checks = r.reference.check(r.statements, answers, r.seed)
    limits = r.cell.config["limits"]
    failed = sum(1 for rec in r.records if rec[4])
    log(f"window: {len(r.completed())} answered, rate {r.rate()!r}/s, "
        f"p50 {r.percentile_ms(50)!r} ms, p95 {r.percentile_ms(95)!r} ms")
    compared = {"failed_statements": {"value": failed, "limit": 0}}
    for name, limit in limits.items():
        compared[name] = {"value": checks[name], "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in compared.values()) \
        and checks.get("answers_compared", 1) > 0
    metrics = {}
    for m in (r.cell.per_layer if trace else r.cell.end_to_end):
        value = _reader(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind,
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": len(r.records),
           "failed": failed, "metrics": metrics, "device": device}
    if trace and r.slice is not None:
        device["busy_s"] = r.slice.busy_s()
        device["window_s"] = r.slice.window_s
        out["breakdown"] = {"device_ops": r.slice.device_ops(),
                            "idle_gaps": r.slice.idle_gaps()}
    out["checks"] = compared
    return out


def forbidden_modules() -> list[str]:
    """Modules in this process whose top-level name is forbidden, compared
    whole (`serenedb_tpu_torch` is not `serenedb_tpu`)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cache_dirs(root: Path) -> dict:
    """Fixed directories inside the checkout for every build and kernel
    cache, so that only a checkout's first run builds."""
    base = root / ".portbench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "CUDA_CACHE_PATH": str(base / "nv"),
            "USE_FLAX": "0"}


def main(argv: list | None = None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    os.environ.update(cache_dirs(ROOT))
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
