"""The manifest keeps the contract's rules, and a configuration, a traffic
mix and a per-layer metric are added as new files and entries alone."""

import json
import shutil

import pytest

from harness.manifest import BENCH_DIR, NAME, ROOT, UNIT, Manifest

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        own = [x["name"] for x in BENCH[group]]
        assert len(own) == len(set(own)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and len(m["unit"]) <= 16, m["name"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    man = Manifest()
    for cell in man.cells:
        got = {m["name"] for m in man.end_to_end_for(cell)}
        assert "setup_s" in got and len(got) >= 2, cell
        assert man.per_layer_for(cell), cell


def test_every_metric_moves_one_that_its_cells_report():
    man = Manifest()
    cells = set(man.cells)
    for m in BENCH["per_layer"]:
        assert m["moves"] in man.end_to_end, m["name"]
        assert set(m.get("workloads", cells)) <= cells, m["name"]
        for cell in m.get("workloads", cells):
            assert m["moves"] in {e["name"] for e in man.end_to_end_for(cell)}, (m["name"], cell)
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_every_file_the_manifest_names_is_there():
    man = Manifest()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    for cell in man.cells.values():
        assert man.driver(man.traffic(cell)).Job
    for m in BENCH["per_layer"]:
        assert callable(man.metric_reader(m["name"]).read)
    assert not [c for c in man.cells.values() if c["chips"] != 1]


def test_a_config_a_traffic_mix_and_a_metric_are_added_by_files_alone(tmp_path):
    """In a copy: a new configuration (Cornell with a green light), a new
    mix (renders at 16 spp), a new per-layer metric (renders a window), and
    their manifest entries. No file that was there changes; the harness
    lists, loads and runs the new cell on the CPU at a tiny frame."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))

    cfg = json.loads((BENCH_DIR / "configs" / "cornell.json").read_text())
    cfg["name"] = "cornell_green"
    cfg["scene"]["spheres"][8]["emission"] = [0.0, 12.0, 0.5]
    (root / "benchmark/configs/cornell_green.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH_DIR / "traffic" / "render.spp64.json").read_text())
    mix["spp"] = 16
    (root / "benchmark/traffic/render.spp16.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/renders.render.py").write_text(
        "def read(job, spans, trace, manifest):\n"
        "    return float(len(spans.durations('bench.render'))) or None\n")
    bench["configs"].append({"name": "cornell_green", "source": "a test's own",
                             "file": "benchmark/configs/cornell_green.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "cornell_green.render.spp16", "config": "cornell_green",
                               "traffic": "render.spp16", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("samples_per_s", "render_p95_ms"):
            m["workloads"].append("cornell_green.render.spp16")
    bench["per_layer"].append({"name": "renders.render", "unit": "renders", "better": "higher",
                               "source": "program_span", "layer": "render driver",
                               "moves": "samples_per_s",
                               "workloads": ["cornell_green.render.spp16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    from harness.runner import run_cell

    man = Manifest(root=root, bench_dir=root / "benchmark")
    cell = "cornell_green.render.spp16"
    assert cell in man.cells
    assert [m["name"] for m in man.per_layer_for(cell)] == ["renders.render"]
    tiny = {"width": 8, "height": 8, "check": {"renders": 1, "pixels": 32, "block": 64}}
    res = run_cell(cell, 5, 0.2, True, device="cpu", overrides=tiny, manifest=man)
    assert res["correct"] and res["metrics"]["renders.render"]["value"] >= 1
    res = run_cell(cell, 5, 0.2, False, device="cpu", overrides=tiny, manifest=man)
    assert set(res["metrics"]) == {"samples_per_s", "render_p95_ms", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("cell", sorted(Manifest().cells))
def test_each_cells_limits_are_in_its_mix(cell):
    man = Manifest()
    traffic = man.traffic(man.cell(cell))
    assert traffic["limits"] and all(v > 0 for v in traffic["limits"].values())
