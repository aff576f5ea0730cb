"""Every cell of BENCHMARK.json resolves to files of its own, by name."""

import json
import re

import pytest

from portbench import run, traffic

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    spec = run.resolve(cell)
    assert spec["cell"]["name"] == cell
    assert spec["config"]["reference"] in ("hierarchical", "sgm")
    assert spec["traffic"] == traffic.load(spec["cell"]["traffic"])
    assert spec["traffic"]["pool"] % spec["traffic"]["chunk"] == 0
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "frames_per_s"}
    assert spec["per_layer"]


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_names_files_and_limits_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for kinds in (("configs",), ("workloads",), ("end_to_end", "per_layer")):
        names = [x["name"] for k in kinds for x in BENCH[k]]
        assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (run.ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((run.ROOT / c["file"]).read_text())["reduced"]
    for m in BENCH["per_layer"]:  # each cell that reads it reports what it moves
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", CELLS)) <= set(moved.get("workloads", CELLS))
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.resolve("no-such-cell")
