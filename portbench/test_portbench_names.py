"""BENCHMARK.json keeps to the contract's names, units and keys, every
name it uses has its files, and nothing the benchmark runs imports JAX or
the JAX package (compared by whole top-level names)."""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "serenedb_tpu"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (HERE.parent / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
    for w in BENCH["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "layer" in m:
            assert TEXT.match(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e

    def cells(m):
        return set(m.get("workloads", [w["name"] for w in BENCH["workloads"]]))
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in BENCH["end_to_end"] if w["name"] in cells(m)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in cells(m) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert cells(m) <= cells(e2e[m["moves"]])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == \
        len(BENCH["workloads"])


def test_every_name_has_its_files():
    for w in BENCH["workloads"]:
        assert (HERE / "gen" / f"{w['config']}.py").is_file()
        assert (HERE / "reference" / f"{w['config']}.py").is_file()
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "re", "dataclasses", "numpy", "math"}
