"""The port's native C++ indexer against its Python builder and the JAX
package's `build_field_index`, on the CPU.

The library builds with g++ from `serenedb_tpu_torch/native/indexer.cpp`
into `serenedb_tpu_torch/_build/` at first use. Its FieldIndex arrays must
equal the port's Python builder's and the reference's, bit for bit, and
`native.BUILDS` must count which path built each index.
"""

import numpy as np
import pytest

from serenedb_tpu.native import build_field_index_native as rnative
from serenedb_tpu.search.analysis import get_analyzer as rget_analyzer
from serenedb_tpu.search.segment import build_field_index as rbuild
from serenedb_tpu_torch import native
from serenedb_tpu_torch.native import BUILDS, build_field_index_native
from serenedb_tpu_torch.search.analysis import get_analyzer
from serenedb_tpu_torch.search.segment import build_field_index

ARRAYS = ("doc_freq", "offsets", "post_docs", "post_tfs", "pos_offsets",
          "positions", "norms", "block_max_tf", "block_offsets")


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, "g++ is present here: the native build must load"
    return lib


def make_docs(n=500, seed=9):
    rng = np.random.default_rng(seed)
    words = [f"word{i}" for i in range(300)] + ["The", "Quick", "FOX_7"]
    docs = []
    for i in range(n):
        docs.append(" ".join(rng.choice(words, rng.integers(3, 40))) +
                    (".,;! punct-uation" if i % 7 == 0 else ""))
    docs[3] = None
    docs[4] = ""
    return docs


def _python_build(docs, an):
    """The port's Python path, reached by disguising the analyzer name."""

    class _NotSimple(type(an)):
        name = "simple-py"
    return build_field_index(docs, _NotSimple())


def _assert_equal(a, b, arrays=ARRAYS):
    assert [str(t) for t in a.terms] == [str(t) for t in b.terms]
    for name in arrays:
        av, bv = getattr(a, name), getattr(b, name)
        assert av.dtype == bv.dtype, name
        np.testing.assert_array_equal(av, bv, err_msg=name)
    assert a.total_tokens == b.total_tokens


@pytest.mark.parametrize("n,seed", [(500, 9), (3000, 1), (7, 2)])
def test_native_matches_python_and_the_reference(lib, n, seed):
    docs = make_docs(n, seed)
    an = get_analyzer("simple")
    py = _python_build(list(docs), an)
    fi = build_field_index(list(docs), an)          # the native path
    _assert_equal(fi, py)
    _assert_equal(fi, rbuild(list(docs), rget_analyzer("simple")))
    raw = build_field_index_native(list(docs))
    _assert_equal(raw, rnative(list(docs)), ARRAYS[:7])


@pytest.mark.parametrize("threads", [1, 2, 3, 7, 16])
def test_threads_give_the_same_index(lib, threads):
    docs = make_docs(n=2000, seed=11)
    one = build_field_index_native(docs, n_threads=1)
    _assert_equal(build_field_index_native(docs, n_threads=threads), one,
                  ARRAYS[:7])
    tiny = ["alpha beta", None, "beta gamma"]
    _assert_equal(build_field_index_native(tiny, n_threads=threads),
                  build_field_index_native(tiny, n_threads=1), ARRAYS[:7])
    nulls = [None, "", None, "", "x"] * 50
    _assert_equal(build_field_index_native(nulls, n_threads=threads),
                  build_field_index_native(nulls, n_threads=1), ARRAYS[:7])


def test_builds_count_the_path_each_index_took(lib):
    an = get_analyzer("simple")
    before = BUILDS.snapshot()
    fi = build_field_index(["hello world hello", "quick brown fox"], an)
    assert fi.term_id("hello") >= 0
    assert fi.block_offsets[-1] == len(fi.block_max_tf)
    mid = BUILDS.snapshot()
    assert mid.get("native", 0) == before.get("native", 0) + 1
    assert mid.get("python", 0) == before.get("python", 0)
    assert mid.get("native_ns", 0) > before.get("native_ns", 0)
    # non-ASCII text and other analyzers take the Python path, whose
    # simple analyzer accent-folds (héllo → hello)
    fi2 = build_field_index(["héllo wörld"], an)
    assert fi2.term_id("hello") >= 0 and fi2.term_id("world") >= 0
    build_field_index(["hello world"], get_analyzer("text"))
    after = BUILDS.snapshot()
    assert after.get("python", 0) == mid.get("python", 0) + 2
    assert after.get("native", 0) == mid.get("native", 0)


def test_create_index_takes_the_native_path(lib):
    """Through SQL: an inverted index with the `simple` analyzer over
    ASCII text is built natively, and searches as the reference's."""
    from serenedb_tpu.engine import Database as RDatabase
    from serenedb_tpu_torch.engine import Database
    docs = [d for d in make_docs(200, 5) if d]
    rows = []
    for db in (RDatabase(), Database(device="cpu")):
        c = db.connect()
        c.execute("CREATE TABLE d (id INT, body TEXT)")
        c.execute("INSERT INTO d VALUES " + ", ".join(
            f"({i}, '{t}')" for i, t in enumerate(docs)))
        before = BUILDS.get("native")
        c.execute("CREATE INDEX ON d USING inverted (body) "
                  "WITH (analyzer = 'simple')")
        if isinstance(db, Database):
            assert BUILDS.get("native") > before
        rows.append(c.execute(
            "SELECT id, bm25(body) AS s FROM d WHERE body @@ 'word7 word9' "
            "ORDER BY s DESC, id LIMIT 10").rows())
    assert [r[0] for r in rows[1]] == [r[0] for r in rows[0]]
    np.testing.assert_allclose([r[1] for r in rows[1]],
                               [r[1] for r in rows[0]], rtol=1e-6)


def test_library_is_named_by_its_source(lib):
    import os
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.basename(os.path.dirname(os.path.dirname(path))) == \
        "serenedb_tpu_torch"
