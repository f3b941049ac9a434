"""Copied from serenedb_tpu/serened.py; the usage line names this package,
and `--device` picks where the device tier runs (`cuda:0` by default,
`cpu` for the plain versions of the kernels).

serened — the server process entry point.

Reference analog: server/rest_server/serened.cpp (flag parsing, engine boot,
listener bring-up, signal-driven shutdown with ordered teardown;
SURVEY.md §3.1).

    python -m serenedb_tpu_torch.serened [<datadir>] \
        --pg-port 5432 --http-port 9200 [--password secret] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys

from .engine import Database
from .server.http_server import HttpServer
from .server.pgwire import PgServer
from .utils import log


def main(argv=None):
    ap = argparse.ArgumentParser(prog="serened")
    ap.add_argument("datadir", nargs="?", default=None,
                    help="data directory (omit for in-memory)")
    ap.add_argument("--pg-port", type=int, default=5432)
    ap.add_argument("--http-port", type=int, default=9200)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--password", default=None)
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument("--tls-cert", default=None,
                    help="PEM certificate chain; enables in-band TLS "
                         "upgrade on SSLRequest")
    ap.add_argument("--tls-key", default=None, help="PEM private key")
    ap.add_argument("--hba-config", default=None,
                    help="pg_hba.conf-style rules file")
    ap.add_argument("--proxy-protocol", default="off",
                    choices=["off", "optional", "require"],
                    help="HAProxy PROXY v1/v2 preface handling")
    ap.add_argument("--listen", action="append", default=[],
                    metavar="SPEC",
                    help="additional PG listener: tcp://HOST:PORT or "
                         "unix:///path.sock (repeatable; reference: "
                         "listen_spec.h multi-spec --listen)")
    ap.add_argument("--device", default=None,
                    help="where the device tier runs: cuda (default) or "
                         "cpu; with a data directory, its tables and "
                         "indexes are recovered onto this device")
    ap.add_argument("--version", action="store_true",
                    help="print version/build id and exit")
    args = ap.parse_args(argv)
    if args.version:
        from . import build_id
        print(build_id())
        return
    from .server.listen import parse_listen_spec
    for spec in args.listen:
        try:
            parse_listen_spec(spec, default_host=args.host)
        except ValueError as e:
            ap.error(str(e))
    if bool(args.tls_cert) != bool(args.tls_key):
        ap.error("--tls-cert and --tls-key must be given together")

    # environment-driven configuration: any registered setting may be
    # seeded at boot via its SHOUTING name (SERENE_MAX_CONNECTIONS=100,
    # SERENE_DEVICE=cpu, ...) — the standard server-deployment surface
    # for GLOBAL-scope knobs, which have no SQL-level setter
    from .utils.config import REGISTRY as settings
    for name in settings.names():
        env_val = os.environ.get(name.upper())
        if env_val is not None:
            try:
                settings.set_global(name, env_val)
            except ValueError as e:
                ap.error(f"{name.upper()}: {e}")

    log.MANAGER.stdout = True
    db = Database(args.datadir, device=args.device)
    pg = PgServer(db, args.host, args.pg_port, args.password,
                  tls_cert=args.tls_cert, tls_key=args.tls_key,
                  hba_conf=args.hba_config,
                  proxy_protocol=args.proxy_protocol,
                  listen=args.listen)

    if bool(settings.get_global("serene_frontdoor")):
        # the front door: BOTH protocols on the process's one event
        # loop, pgwire's session pool shared as the HTTP engine-boundary
        # executor, one ordered drain on shutdown (server/frontdoor.py)
        from .server.frontdoor import FrontDoor
        front = FrontDoor(db, args.host, http_port=args.http_port, pg=pg)

        async def run():
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            await front.start_async()
            print(f"serened ready: pg={pg.port} http={front.port}",
                  flush=True)
            await stop.wait()
            # teardown order mirrors the reference: listeners drain,
            # sessions reaped, then the store closes
            await front.stop_async()

        try:
            asyncio.run(run())
        finally:
            db.close()
            log.info("serened", "shutdown complete")
        return

    # legacy split lifecycle (serene_frontdoor = off, one release):
    # HTTP on its own thread-per-connection server, pg on the main loop
    http = HttpServer(db, args.host, args.http_port)
    http.start()

    async def run_legacy():
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await pg.start()
        print(f"serened ready: pg={pg.port} http={http.port}",
              flush=True)
        await stop.wait()
        await pg.stop()

    try:
        asyncio.run(run_legacy())
    finally:
        http.stop()
        db.close()
        log.info("serened", "shutdown complete")


if __name__ == "__main__":
    main(sys.argv[1:])
