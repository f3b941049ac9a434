"""Run a reference test file against the port.

`port_module("test_pgwire")` reads `tests/test_pgwire.py`, points it at
`serenedb_tpu_torch` and executes it as a module of its own; the port's
`tests/test_torch_pgwire.py` then takes its names with
`globals().update(exported(port_module(...)))`, so pytest collects every
reference test there as a port case held to the reference's own
assertion. The reference file itself is read, never edited.

The rewrites every file takes follow the port's standing rules:

- `serenedb_tpu` names the port's package;
- `Database(...)` and `SegmentSearcher(...)` construct on the CPU
  (`device="cpu"`, unless the call passes a device), since the port's
  otherwise need a card;
- `'tpu'` as a `serene_device` value is `'gpu'`;
- a reference test module imported by name (`from test_pgwire import
  RawPg`) is its port version, so a helper that starts a server starts
  the port's.

A file may add its own rewrites, each a (pattern, replacement) that
must match at least once: a reference edit that removes its target then
fails loudly instead of running unadapted. Asserts are rewritten by
pytest's own rewriter, so failures show their operands.
"""

from __future__ import annotations

import ast
import functools
import os
import re
import sys
import types

_HERE = os.path.dirname(os.path.abspath(__file__))

#: the reference test modules that have a port version (`test_<name>`);
#: an import of one of them by name loads the port version instead
PORTED = ("pgwire", "pgcopy", "cancel_streaming", "rbac", "tls_hba",
          "pgcatalog", "listen", "device_obs", "trace", "profile",
          "resources", "result_cache", "admission", "geo", "regexp",
          "automaton", "scorers", "segments")

COMMON = [
    (r"\bserenedb_tpu\b", "serenedb_tpu_torch"),
    (r"(?<![\w.])(Database|SegmentSearcher)\(", r"_cpu(\1)("),
    (r"'tpu'", "'gpu'"),
    (r"\bfrom (?:tests\.)?test_(" + "|".join(PORTED) + r") import",
     r"from tests.test_torch_\1 import"),
]


def _cpu(cls):
    """`cls` constructed on the CPU unless the caller names a device."""
    def make(*args, **kwargs):
        kwargs.setdefault("device", "cpu")
        return cls(*args, **kwargs)
    return make


def _on_cpu(fn):
    """`fn` run with the CPU as the current device: for a library call
    that builds device state outside any statement (`building_on`)."""
    def run(*args, **kwargs):
        import torch
        from serenedb_tpu_torch.device import building_on
        with building_on(torch.device("cpu")):
            return fn(*args, **kwargs)
    return run


@functools.lru_cache(maxsize=None)
def port_module(name: str, subs: tuple = ()) -> types.ModuleType:
    """`tests/<name>.py` executed against the port: COMMON's rewrites,
    then `subs` ((pattern, replacement) pairs, each of which must match)."""
    path = os.path.join(_HERE, name + ".py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    for pat, rep in COMMON:
        src = re.sub(pat, rep, src)
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if n == 0:
            raise AssertionError(f"{name}: rewrite {pat!r} matched nothing")
    tree = ast.parse(src, filename=path)
    from _pytest.assertion.rewrite import rewrite_asserts
    rewrite_asserts(tree, src.encode(), path)
    mod = types.ModuleType(f"tests._port_{name}")
    mod.__file__ = path
    mod._cpu, mod._on_cpu = _cpu, _on_cpu
    sys.modules[mod.__name__] = mod
    exec(compile(tree, path, "exec"), mod.__dict__)
    return mod


def exported(mod: types.ModuleType) -> dict:
    """The names a port test file takes from `mod`: all but dunders."""
    return {k: v for k, v in mod.__dict__.items() if not k.startswith("__")}
