"""The control of a cell's comparison: the plain reference computed in the
precision below the one the configuration states (`Reference.control`),
put in the program's place at the cell's own size and judged by the same
comparison. It has to come out as not correct; its readings set the upper
end of each limit.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the control's readings beside the limits.
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control(workload: str, seed: int, device, overrides=None) -> dict:
    from portbench import harness
    cell = harness.Cell.find(harness.bench_file(), workload)
    if overrides:
        cell.config = dict(cell.config, **overrides)
    stmts_cfg = cell.traffic.get("statements")
    data = cell.gen.generate(seed, cell.config, harness.columns_read(
        cell, stmts_cfg) if stmts_cfg else None, device)
    stmts = harness.statements(cell, data)
    ref = cell.reference.Reference(data, cell.config)
    readings = ref.control(stmts) if stmts_cfg else ref.control(stmts, seed)
    limits = cell.config["limits"]
    return {"workload": workload, "seed": seed, "readings": readings,
            "limits": limits,
            "correct": all(readings[k] <= v for k, v in limits.items())}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in a.seeds:
        t = time.perf_counter()
        out = control(a.workload, seed, device)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
