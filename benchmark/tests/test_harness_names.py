"""BENCHMARK.json against the contract's character rules, and every
file of a cell found by its name."""

import json
import os
import re
import shutil
import subprocess
import sys

import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = cells.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_names_and_units_use_the_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert _line(c["source"]) and _line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            names.append(m["name"])
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    assert all(_line(w) for w in BENCH["command"])


def test_entries_have_only_the_contract_keys():
    """Every cell reports setup_s, so it lists no cells; a metric adds at
    most `workloads` to its keys, and names only cells that exist."""
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cell_names = {w["name"] for w in BENCH["workloads"]}
    base = {"end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for kind, keys in base.items():
        for m in BENCH[kind]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert set(m.get("workloads", [])) <= cell_names, m["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        others = [e for e in BENCH["end_to_end"] if e["name"] != "setup_s"
                  and w["name"] in e.get("workloads", cell_names)]
        assert others, w["name"]


def test_each_cell_finds_its_files_by_name():
    for w in BENCH["workloads"]:
        cfg = cells.config(w["config"])
        assert cfg["engine"]["num_cameras"] >= 1
        t = cells.traffic(w["traffic"])
        assert t["period"] > 0
        assert isinstance(cells.limits(w["name"]), dict)
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(cells.ROOT, c["file"]))
    for m in BENCH["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_an_added_file_is_found_with_no_other_edit(tmp_path):
    """A copy of the benchmark with a new configuration, mix, cell and
    metric added as files and entries finds each by its name."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    b = root / "benchmark"
    (b / "configs" / "new_cfg.json").write_text(
        (b / "configs" / "bench4cam_k30.json").read_text())
    (b / "traffic" / "new_mix.json").write_text(
        (b / "traffic" / "sparse8.json").read_text())
    (b / "limits" / "new_cfg.new_mix.json").write_text("{}")
    (b / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "frames_per_s",
                               "workloads": ["new_cfg.new_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, 'benchmark'); import cells\n"
        "b = cells.benchmark(); w = cells.cell(b, 'new_cfg.new_mix')\n"
        "assert cells.config(w['config'])['engine']\n"
        "assert cells.traffic(w['traffic'])['people'] == 8\n"
        "assert cells.limits(w['name']) == {}\n"
        "ms = [m['name'] for m in cells.metrics_of(b, w['name'], 'per_layer')]"
        "\nassert ms == ['new_metric'], ms\n"
        "assert cells.reader('new_metric')({}) == 42.0\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True)
