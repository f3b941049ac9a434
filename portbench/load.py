"""The load: one client process, apart from the server's, drives every
connection of a cell from one asyncio thread (`client_main`), so the
clients share no interpreter lock with the server and add few threads of
their own.

Each connection runs a closed loop over its own sequence of statement
indices: it sends the next statement when the previous one's
ReadyForQuery has come, with no think time, and times each from its send
to that ReadyForQuery on `time.perf_counter` (CLOCK_MONOTONIC, the
server process's clock too).

The process is `python -m portbench.load`; it talks with the harness in
JSON lines on its standard input and output:
  harness -> {"port", "statements", "orders", "warm_each", "warm"}
  client  -> ["warm", errors]          every statement once on one connection
                                       (with `warm_each`), then `warm` more
                                       on every connection, concurrently
  harness -> ["go", t0, t1]            the window
  client  -> ["done", records]         one record a statement sent in it:
             [connection, statement index, sent, answered, error, rows]
"""

from __future__ import annotations

import asyncio
import json
import sys
import time

from portbench.pgwire_client import AsyncPgConn


def _send(msg) -> None:
    sys.stdout.write(json.dumps(msg) + "\n")
    sys.stdout.flush()


async def _run(job: dict) -> None:
    loop = asyncio.get_running_loop()
    conns = [await AsyncPgConn.open(job["port"]) for _ in job["orders"]]
    stmts, orders, warm = job["statements"], job["orders"], job["warm"]
    try:
        async def warm_one(c: int) -> list:
            errors = []
            for j in range(warm):
                conns[c].send(stmts[orders[c][j % len(orders[c])]])
                ans = await conns[c].answer()
                if ans.error:
                    errors.append(ans.error)
            return errors

        errs = []
        if job["warm_each"]:
            for sql in stmts:
                conns[0].send(sql)
                ans = await conns[0].answer()
                if ans.error:
                    errs.append(ans.error)
        for es in await asyncio.gather(*(warm_one(c)
                                         for c in range(len(conns)))):
            errs.extend(es)
        _send(["warm", errs])
        _, t0, t1 = json.loads(await loop.run_in_executor(
            None, sys.stdin.readline))

        async def window(c: int) -> list:
            out, order, pos = [], orders[c], warm
            now = time.perf_counter()
            if now < t0:
                await asyncio.sleep(t0 - now)
            while time.perf_counter() < t1:
                idx = order[pos % len(order)]
                pos += 1
                sent = time.perf_counter()
                conns[c].send(stmts[idx])
                ans = await conns[c].answer()
                out.append((c, idx, sent, time.perf_counter(), ans.error,
                            ans.rows))
            return out

        recs = await asyncio.gather(*(window(c) for c in range(len(conns))))
        _send(["done", [r for rs in recs for r in rs]])
    finally:
        for conn in conns:
            await conn.close()


if __name__ == "__main__":
    asyncio.run(_run(json.loads(sys.stdin.readline())))
