"""The sqllogic corpus on the port: the recovery leg, on the CPU.

The files of `tests/sqllogic/recovery/` (`tests/test_sqllogic.py`
`RECOVERY_FILES`) on a port data directory: `restart` closes and reopens
it, `statement crash` dies on an armed fault point, abandons the
database without a flush and reopens it from disk, as the reference's
`test_sqllogic_recovery` drives its own package.
"""

import pytest

from serenedb_tpu_torch.engine import Database
from serenedb_tpu_torch.utils import faults
from test_sqllogic import RECOVERY_FILES
from test_torch_sqllogic import _ids, run_test_file, scratch_cwd


@pytest.mark.parametrize("path", RECOVERY_FILES, ids=_ids(RECOVERY_FILES))
def test_torch_sqllogic_recovery(path, tmp_path):
    datadir = str(tmp_path / "data")
    state = {"db": Database(datadir, device="cpu")}
    faults.set_crash_mode("raise")

    def reopen():
        state["db"].close()
        faults.clear()  # a restarted "process" starts with no armed faults
        state["db"] = Database(datadir, device="cpu")
        return state["db"].connect()

    def crash_reopen():
        state["db"].crash()  # abandon: no close/flush, lock released
        faults.clear()
        state["db"] = Database(datadir, device="cpu")
        return state["db"].connect()

    try:
        with scratch_cwd(tmp_path):
            failures = run_test_file(state["db"].connect(), path,
                                     reopen=reopen,
                                     crash_reopen=crash_reopen,
                                     tmpdir=str(tmp_path))
        assert not failures, "\n".join(failures)
    finally:
        faults.set_crash_mode("exit")
        faults.clear()
        state["db"].close()
