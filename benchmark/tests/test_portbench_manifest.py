"""The manifest and every file it names: each cell, configuration, traffic
mix and metric loads by name, the manifest keeps to the contract's forms,
and a new cell and a new metric come from new files alone."""

import json
import re
import shutil
import types

import pytest

from portbench import manifest

ROOT = manifest.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_forms():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += [c["name"] for c in MANIFEST["configs"]] + CELLS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            # every cell that reports the metric reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_its_files_by_name(cell):
    c = manifest.load_cell(cell)
    for fn in ("setup", "window", "measure", "release", "check"):
        assert callable(getattr(c.kind, fn))
    assert {"cli", "reference", "precision", "source"} <= set(c.config)
    assert c.limits, "the cell's limits file"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(manifest.metric_reader(m["name"]).read)


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_each_config_file(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"] == []
    assert data["source"].startswith(config["source"].split(" ")[0])


def test_a_new_cell_and_metric_are_new_files_alone(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    traffic = json.loads((bench / "traffic" / "serve_tta.json").read_text())
    traffic["inference_flags"] = [f for f in traffic["inference_flags"] if f != "--tta"]
    (bench / "traffic" / "serve_plain.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "assp_evo_w48.serve_plain.json").write_text('{"label_mismatch": 0.01}')
    (bench / "metrics" / "save_ms.serve.py").write_text(
        "def read(ctx, name):\n    return 1.5\n")
    entry = dict(name="assp_evo_w48.serve_plain", config="assp_evo_w48",
                 traffic="serve_plain", chips=1, why="no TTA")
    doc = json.loads(json.dumps(MANIFEST))
    doc["workloads"].append(entry)
    doc["end_to_end"][0]["workloads"].append(entry["name"])
    doc["per_layer"].append(dict(name="save_ms.serve", unit="ms", better="lower",
                                 source="host_clock", layer="data", moves="cases_per_s",
                                 workloads=[entry["name"]]))
    cell = manifest.load_cell(entry["name"], doc, bench)
    assert cell.limits == {"label_mismatch": 0.01}
    assert "--tta" not in cell.traffic["inference_flags"]
    assert [m["name"] for m in cell.per_layer] == ["save_ms.serve"]
    assert manifest.metric_reader("save_ms.serve", bench).read(None, "save_ms.serve") == 1.5
    assert all(p.read_bytes() == data for p, data in before.items())


def test_reader_lookup_drops_dotted_suffixes():
    assert manifest.metric_reader("mfu.serve").__file__.endswith("mfu.py")
    assert manifest.metric_reader("conv3x3x3_roofline.train").__file__.endswith(
        "conv3x3x3_roofline.py")
    assert manifest.metric_reader("data_wait_ms.serve").__file__.endswith(
        "data_wait_ms.serve.py")
    assert manifest.metric_reader("case_latency_p90_s").read(
        types.SimpleNamespace(latencies_s=[float(i) for i in range(11)]),
        "case_latency_p90_s") == 9.0
    assert manifest.metric_reader("no_such_metric.serve") is None


def test_traffic_post_processing_matches_its_flags():
    for name in ("serve_tta",):
        t = json.loads((manifest.BENCH_DIR / "traffic" / f"{name}.json").read_text())
        flags = t["inference_flags"]
        assert float(flags[flags.index("--cleaning_areas_threshold") + 1]) == \
            t["post"]["cleaning_areas_threshold"]
        assert float(flags[flags.index("--replace_value_threshold") + 1]) == \
            t["post"]["replace_value_threshold"]


def test_every_file_name_is_made_of_name_characters():
    for p in manifest.BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
