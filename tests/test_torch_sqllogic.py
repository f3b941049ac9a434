"""The sqllogic corpus on the port: the in-memory leg, on the CPU.

The files `tests/test_sqllogic.py` collects in `FILES` run on a fresh
port `Database(device="cpu")` each, through a copy of
`tests/sqllogic_runner.run_test_file` and `format_value` that names the
port's types, binder, pgwire, pgcopy, `SqlError` and `FaultInjected`
(the runner's own copies name the reference's). Parsing and the golden
comparison name neither package and are the runner's own. The durable
and recovery legs (`test_torch_sqllogic_durable.py`,
`test_torch_sqllogic_recovery.py`) share this adaptation.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import pytest

from serenedb_tpu_torch.engine import Database
from tests.sqllogic_runner import (compare_query, parse_test_file,
                                   substitute_tmpdir)
from test_sqllogic import FILES, _ids


def format_value(v, typ=None) -> str:
    """sqllogic_runner.format_value over the port's types."""
    if v is None:
        return "NULL"
    if typ is not None:
        from serenedb_tpu_torch.columnar import dtypes as dt
        if typ.id is dt.TypeId.TIMESTAMP:
            from serenedb_tpu_torch.sql.binder import format_timestamp
            return format_timestamp(int(v))
        if typ.id is dt.TypeId.DATE:
            import numpy as np
            return str(np.datetime64(int(v), "D"))
        if typ.id is dt.TypeId.INTERVAL:
            from serenedb_tpu_torch.sql.binder import format_interval
            return format_interval(int(v))
        if typ.id is dt.TypeId.ARRAY:
            from serenedb_tpu_torch.server.pgwire import _pg_array_text
            return _pg_array_text(str(v)).decode()
        if typ.id is dt.TypeId.RECORD:
            from serenedb_tpu_torch.columnar.pgcopy import record_text
            return record_text(str(v))
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return f"{v:.3f}".rstrip("0").rstrip(".")
    return str(v)


def run_test_file(conn, path: str, reopen=None, crash_reopen=None,
                  tmpdir: Optional[str] = None) -> list[str]:
    """sqllogic_runner.run_test_file on a port connection: a list of
    failure descriptions, empty when the file passes."""
    from serenedb_tpu_torch.errors import SqlError
    from serenedb_tpu_torch.utils.faults import FaultInjected
    failures = []
    conns = {"default": conn}
    for rec in parse_test_file(path):
        where = f"{path}:{rec.line}"
        if rec.kind == "connection":
            name = rec.sql
            if name not in conns:
                conns[name] = conn.db.connect()
            conn = conns[name]
            continue
        if rec.kind == "restart":
            if reopen is None:
                failures.append(f"{where}: restart in non-durable run")
                break
            conn = reopen()
            conns = {"default": conn}
            continue
        if rec.kind == "statement" and rec.expect_error == "__crash__":
            try:
                conn.execute(substitute_tmpdir(rec.sql, tmpdir))
                failures.append(f"{where}: expected crash, got success")
            except FaultInjected:
                if crash_reopen is None:
                    failures.append(f"{where}: crash in non-durable run")
                    break
                conn = crash_reopen()
            except SqlError as e:
                failures.append(f"{where}: wanted crash fault, got {e!r}")
            continue
        try:
            result = conn.execute(substitute_tmpdir(rec.sql, tmpdir))
            if rec.kind == "statement" and rec.expect_error is not None:
                failures.append(f"{where}: expected error, got success")
                continue
            if rec.kind == "query":
                tys = [c.type for c in result.batch.columns]
                actual = [" ".join(format_value(v, tys[i])
                                   for i, v in enumerate(row))
                          for row in result.rows()]
                compare_query(rec, actual, where, failures)
        except SqlError as e:
            if rec.expect_error is None:
                failures.append(f"{where}: unexpected error: {e.message}")
            elif rec.expect_error and rec.expect_error not in e.message \
                    and rec.expect_error != e.sqlstate:
                failures.append(
                    f"{where}: error mismatch: wanted {rec.expect_error!r} "
                    f"in {e.message!r}")
    return failures


@contextlib.contextmanager
def scratch_cwd(tmp_path):
    """Relative COPY TO/FROM paths land in the test's tmp dir."""
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.mark.parametrize("path", FILES, ids=_ids(FILES))
def test_torch_sqllogic_memory(path, tmp_path):
    db = Database(device="cpu")
    try:
        with scratch_cwd(tmp_path):
            failures = run_test_file(db.connect(), path,
                                     tmpdir=str(tmp_path))
        assert not failures, "\n".join(failures)
    finally:
        db.close()


def test_runner_reports_a_wrong_expectation(tmp_path):
    """The adaptation compares: a deliberately wrong golden value, a
    missing expected error and an unexpected one are each reported."""
    f = tmp_path / "wrong.test"
    f.write_text("statement ok\nCREATE TABLE t (a INT)\n\n"
                 "statement ok\nINSERT INTO t VALUES (1), (2)\n\n"
                 "query I\nSELECT a FROM t ORDER BY a\n----\n1\n3\n\n"
                 "statement error\nSELECT a FROM t\n\n"
                 "statement ok\nSELECT nope FROM t\n")
    db = Database(device="cpu")
    try:
        failures = run_test_file(db.connect(), str(f))
    finally:
        db.close()
    assert len(failures) == 3, failures
    assert "mismatch" in failures[0]
    assert "expected error" in failures[1]
    assert "unexpected error" in failures[2]
