#!/usr/bin/env python3
"""Start `python -m serenedb_tpu_torch.serened`, talk to it, stop it.

    python3 scripts/serened_smoke.py [--device cpu]

Loads three documents over the ES `_bulk` API, runs a `match` search over
HTTP and one `@@` statement over the PG wire (raw protocol bytes), prints
both answers, and stops the server. Without `--device` the server runs
its device tier on `cuda:0`. Exits non-zero when any step fails.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from serenedb_tpu_torch.server.client import http, pg_rows  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    pg_port, http_port = free_port(), free_port()
    cmd = [sys.executable, "-m", "serenedb_tpu_torch.serened",
           "--pg-port", str(pg_port), "--http-port", str(http_port)]
    if args.device:
        cmd += ["--device", args.device]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            if "serened ready" in line:
                print(line.strip())
                break
            if time.monotonic() > deadline:
                raise TimeoutError("serened did not start")
        else:
            raise RuntimeError(f"serened exited with {proc.wait()}")
        # keep draining the server's log so it never blocks on the pipe
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        docs = ["quick brown fox", "lazy dog sleeps", "quick dog runs"]
        bulk = "".join(json.dumps({"index": {"_index": "books",
                                             "_id": str(i)}}) + "\n" +
                       json.dumps({"body": d}) + "\n"
                       for i, d in enumerate(docs))
        print("bulk errors:", http(http_port, "POST", "/_bulk", bulk,
                                   True)["errors"])
        hits = http(http_port, "POST", "/books/_search",
                    {"query": {"match": {"body": "quick"}}})
        print("search:", [(h["_id"], h["_score"])
                          for h in hits["hits"]["hits"]])
        print("pg:", pg_rows(pg_port, "SELECT \"_id\", bm25(body) AS s "
                                      "FROM books WHERE body @@ 'dog' "
                                      "ORDER BY s DESC LIMIT 10"))
        return 0
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    sys.exit(main())
