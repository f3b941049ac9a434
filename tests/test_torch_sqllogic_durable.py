"""The sqllogic corpus on the port: the durable leg, on the CPU.

Every file of the in-memory leg (`tests/test_sqllogic.py` `FILES`) runs
on a fresh port data directory, `Database(path, device="cpu")`: each
statement goes through the WAL and the catalog, as the reference's
`test_sqllogic_durable` runs them on its own package.
"""

import pytest

from serenedb_tpu_torch.engine import Database
from test_torch_sqllogic import FILES, _ids, run_test_file, scratch_cwd


@pytest.mark.parametrize("path", FILES, ids=_ids(FILES))
def test_torch_sqllogic_durable(path, tmp_path):
    db = Database(str(tmp_path / "data"), device="cpu")
    try:
        with scratch_cwd(tmp_path):
            failures = run_test_file(db.connect(), path,
                                     tmpdir=str(tmp_path))
        assert not failures, "\n".join(failures)
    finally:
        db.close()
