"""The sqllogic corpus over the port's Postgres wire, on the CPU.

The files `tests/test_sqllogic_wire.py` collects run against a live port
`PgServer` over a fresh `Database(device="cpu")` each, in its three
modes (simple, extended text, extended binary), through that file's
`WireClient` and `tests/sqllogic_runner.run_test_file_wire`. The client,
the runner and the golden comparison name no server package; only the
server and the database here are the port's.
"""

import asyncio
import os
import threading

import pytest

from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.server.pgwire import PgServer
from tests.sqllogic_runner import run_test_file_wire
from tests.test_pgwire import RawPg
from tests.test_sqllogic_wire import FILES, MODES, WireClient, _ids


@pytest.fixture
def wire_db(tmp_path):
    """A fresh port database and a live port PgServer per behavior file,
    served from its own event loop thread; stopped on that loop."""
    db = Database(device="cpu")
    srv = PgServer(db, port=0)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def go():
            await srv.start()
            started.set()
            await asyncio.Event().wait()
        try:
            loop.run_until_complete(go())
        except RuntimeError:
            pass
    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert started.wait(20), "pg server failed to start"
    old = os.getcwd()
    os.chdir(tmp_path)   # relative COPY paths land in tmp
    try:
        yield srv
    finally:
        os.chdir(old)
        done = threading.Event()

        def _shutdown():
            task = loop.create_task(srv.stop())
            task.add_done_callback(lambda _: (loop.stop(), done.set()))
        loop.call_soon_threadsafe(_shutdown)
        done.wait(10)
        db.close()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("path", FILES, ids=_ids(FILES))
def test_torch_sqllogic_wire(path, mode, wire_db, tmp_path):
    pg = RawPg(wire_db.port)
    try:
        failures = run_test_file_wire(WireClient(pg, mode).execute, path,
                                      tmpdir=str(tmp_path))
        assert not failures, "\n".join(failures[:8])
    finally:
        pg.close()
