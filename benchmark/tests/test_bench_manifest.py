"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""
import json
import os
import re

import pytest

from slambench import manifest

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(MAN) == TOP
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(manifest.MANIFEST) <= 64 * 1024


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_only_contract_keys(kind, keys):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert set(e) <= keys, (e["name"], set(e) - keys)
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_names_and_units():
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}


def test_per_layer_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in MAN["workloads"]]):
            assert manifest.applies(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in manifest.cell_metrics(MAN, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(MAN, w["name"], True)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    res = manifest.resolve(MAN, cell)
    assert res["config"]["system"] == "FusedSlam"
    assert manifest.system_file(res["config"]["system"]).is_file()
    assert res["traffic"]["warmup"]
    assert res["cell"]["limits"]
    for m in manifest.cell_metrics(MAN, cell, True):
        assert callable(manifest.load_reader(m["name"]))


def test_config_files_are_their_own_and_under_paths():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("benchmark/") and os.path.exists(manifest.ROOT / f)
    for c in MAN["configs"]:
        cfg = manifest.read_json(manifest.ROOT / c["file"])
        for k in c["reduced"]:
            assert k in cfg and k in cfg["source_values"]


def test_every_config_used_and_pairs_unique():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


def test_check_budget_fits():
    n = 24  # the most cells a later change may bring
    total = (2 + 14 * n) * (MAN["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_new_cell_is_files_alone(tmp_path, monkeypatch, render_cache):
    """A cell added by files and an entry alone runs through the harness:
    a traffic mix, a limits file and a configuration, no code."""
    from conftest import tiny
    from slambench.harness import run_cell

    import shutil

    bench = tmp_path / "benchmark"
    for d in ("traffic", "cells", "configs", "metrics"):
        (bench / d).mkdir(parents=True)
    shutil.copytree(manifest.BENCH_DIR / "systems", bench / "systems",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "traffic" / "cold4.json").write_text(json.dumps(
        {"warmup": {"frames": 4}, "imu_noise": True,
         "pixel_noise_frac": 0.001, "check_keyframes": 1}))
    res = tiny("tiny_vi", "cold")
    (bench / "configs" / "tiny_vi.json").write_text(json.dumps(res["config"]))
    (bench / "cells" / "tiny_vi.cold4.json").write_text(json.dumps(
        {"limits": {"fe_mismatch": 0.0, "lost_share": 0.5}}))
    (bench / "metrics" / "frames_read.py").write_text(
        "def read(run):\n    return run.frames\n")
    man = dict(MAN)
    man["configs"] = MAN["configs"] + [{"name": "tiny_vi", "source": "test", "reduced": [],
                                        "file": "benchmark/configs/tiny_vi.json", "why": "t"}]
    man["workloads"] = MAN["workloads"] + [{"name": "tiny_vi.cold4", "config": "tiny_vi",
                                            "traffic": "cold4", "chips": 1, "why": "t"}]
    man["per_layer"] = [{"name": "frames_read", "unit": "frames", "better": "higher",
                         "source": "host_clock", "layer": "t", "moves": "tracked_fps",
                         "workloads": ["tiny_vi.cold4"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    monkeypatch.setattr(manifest, "BENCH_DIR", bench)
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    monkeypatch.setattr(manifest, "MANIFEST", tmp_path / "BENCHMARK.json")
    out = run_cell("tiny_vi.cold4", 5, 3.0, True, device="cpu", cache_dir=render_cache,
                   workers=1)
    assert out["correct"], out["checks"]
    assert out["metrics"]["frames_read"]["value"] >= 1
    assert set(out["checks"]) == {"fe_mismatch", "lost_share"}
