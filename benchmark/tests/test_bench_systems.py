"""System drivers found by name (benchmark/systems/<system>.py), the loop
closer switched on by a configuration's `loop` object, a world with a
blackout, and kf_ate_m, on the CPU."""
import json

import numpy as np
import pytest
import torch

from conftest import tiny
from slambench import harness, manifest, traffic
from slambench.harness import run_cell
from slambench.trace import Trace

SEED = 2**31 + 1919

# a system that answers every frame with the world's true pose: a driver
# file and nothing else
ORACLE = '''
import numpy as np


class Driver:
    def __init__(self, config, sessions, device, trace=False):
        self.s = sessions[0]
        self.next = 0
        self.spans = [] if trace else None

    def remaining(self):
        return len(self.s.times) - self.next

    def step(self):
        i = self.next
        self.next += 1
        return [((0, i), 1e-3)]

    def finish(self):
        pass

    imu_initialized = True

    def counters(self):
        return {"timing": {"answer": [1e-3 * self.next, self.next]}, "answers": self.next}

    def outputs(self):
        q, p = zip(*(self.s.world.gt_pose(t) for t in self.s.times[:self.next]))
        rows = {"kf_valid": np.zeros(0, bool), "kf_time": np.zeros(0), "kf_p": np.zeros((0, 3)),
                "mp_pos": np.zeros((0, 3))}
        return {"sessions": [{"poses": np.concatenate([np.stack(q), np.stack(p)], axis=1),
                              "modes": np.ones(self.next, int), "rows": rows}]}

    def close(self):
        pass
'''


def _bench_dir(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    for d in ("systems", "metrics"):
        (bench / d).mkdir(parents=True)
    monkeypatch.setattr(manifest, "BENCH_DIR", bench)
    return bench


def test_new_system_is_a_driver_file_alone(tmp_path, monkeypatch, render_cache):
    """A configuration naming a system whose driver is a new file runs
    through the harness, with its counters and its own reader."""
    bench = _bench_dir(tmp_path, monkeypatch)
    (bench / "systems" / "Oracle.py").write_text(ORACLE)
    (bench / "metrics" / "answers.py").write_text(
        "def read(run):\n    return run.counters['answers'] / run.frames\n")
    res = tiny("tiny_vi", "cold")
    res["config"] = dict(res["config"], system="Oracle", n_frames=12)
    res["cell"] = {"limits": {"ate_m": 1e-6, "lost_share": 0.0, "pose_err_max_m": 1e-6}}
    res["metrics"] = [{"name": "answers", "unit": "x"}]
    out = run_cell("oracle", SEED, 0.05, True, resolved=res, device="cpu",
                   cache_dir=render_cache, workers=1)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    assert out["metrics"]["answers"]["value"] == 1.0


def test_unknown_system_names_the_driver_directory():
    with pytest.raises(KeyError, match="NoSuchSystem.py is not in .*systems"):
        manifest.load_driver("NoSuchSystem")
    assert manifest.load_driver("FusedSlam").__name__ == "Driver"


def test_unknown_loop_config_field_raises(render_cache):
    res = tiny("tiny_vi", "cold")
    res["config"] = dict(res["config"], n_frames=12, loop={
        "vocabulary": {"train": "session", "k": 4, "levels": 2},
        "loop_cfg": {"recent_gap": 3, "no_such_field": 1}})
    with pytest.raises(KeyError, match="no_such_field"):
        run_cell("tiny", SEED, 1.0, False, resolved=res, device="cpu", cache_dir=render_cache,
                 workers=1)


def test_euroc_render_key_is_unchanged():
    """euroc_mh_vi's rendering keeps its cache key (no cell renders again);
    a blackout keys a world of its own."""
    cfg = manifest.read_json(manifest.config_file(manifest.load(), "euroc_mh_vi"))
    assert "blackout" not in cfg
    wcfg = traffic.world_config(cfg, cfg["world_seeds"][0])
    assert traffic._key(wcfg) == "b2bbbbb5a5469218"
    assert traffic._key(wcfg, [10.0, 13.0]) != traffic._key(wcfg)


def test_blackout_frames_are_gray_and_the_rest_unchanged(render_cache):
    with open(manifest.BENCH_DIR / "tests" / "data" / "tiny_vi.json") as f:
        cfg = json.load(f)
    cfg["n_frames"] = 12
    lit = traffic.build(cfg, {}, 1, render_cache, workers=1, log=lambda m: None)[0]
    dark = traffic.build(dict(cfg, blackout=[0.2, 0.35]), {}, 1, render_cache, workers=1,
                         log=lambda m: None)[0]
    gray = (lit.times >= 0.2) & (lit.times < 0.35)
    assert gray.tolist() == [False] * 4 + [True] * 3 + [False] * 5
    assert (dark.frames[gray] == 127).all()
    assert np.array_equal(dark.frames[~gray], lit.frames[~gray])
    for x, y in zip(dark.imu, lit.imu):
        assert all(np.array_equal(a, b) for a, b in zip(x, y))


def test_loop_configuration_runs_and_reports_kf_ate(render_cache, monkeypatch):
    """A tiny loop configuration (tiny_vi's sizes, a blackout, a
    vocabulary trained in set-up on the session's images) through run_cell:
    the loop closer detects in the window, its counts and timers are the
    window's, and kf_ate_m is reported where the limits name it. (The
    per-layer path without the profiler, which on the CPU would record
    every operator of the window.)"""
    torch.set_num_threads(2)
    res = tiny("tiny_vi", "cold")
    res["config"] = dict(res["config"], n_frames=64, blackout=[2.6, 2.8], loop={
        "vocabulary": {"train": "session", "k": 4, "levels": 3},
        "loop_cfg": {"recent_gap": 3, "consistency_needed": 2, "bow_min_score_gate": False},
        "warmup": False})
    res["traffic"] = {"warmup": {"frames": 8}, "imu_noise": True, "pixel_noise_frac": 0.001,
                      "check_keyframes": 1}
    res["cell"] = {"limits": {"kf_ate_m": 1.0, "lost_share": 1.0}}
    res["metrics"] = [{"name": n, "unit": "x"} for n in ("loop_detects", "loop_candidates")]
    calls = {}
    readers = {"loop_detects": lambda run: calls.setdefault(
                   "detect", run.counters["timing"].get("loop.detect", [0.0, 0])[1]),
               "loop_candidates": lambda run: calls.setdefault(
                   "loop", run.counters["loop"])["candidates_checked"]}
    monkeypatch.setattr(manifest, "load_reader", readers.__getitem__)
    monkeypatch.setattr(harness, "Trace", lambda enabled, cuda: Trace(False, cuda))
    out = run_cell("tiny_loop", SEED, 600.0, True, resolved=res, device="cpu",
                   cache_dir=render_cache, workers=1)
    assert out["attempted"] == 64 - 8
    assert calls["detect"] >= 1, calls
    assert set(calls["loop"]) >= {"candidates_checked", "verified", "corrected"}
    assert set(out["checks"]) == {"kf_ate_m", "lost_share"}
    kf = out["checks"]["kf_ate_m"]["value"]
    assert 0.0 < kf < 1.0, out["checks"]


def test_vocabulary_from_a_file():
    """`{"file": ...}` reads a vocabulary of the checkout by its suffix."""
    vocabulary = manifest.load_driver("FusedSlam").__init__.__globals__["vocabulary"]
    voc = vocabulary({"file": "orbslam3_tpu_torch/data/vocab_bench.npz"}, None, "cpu")
    assert voc.k == 10 and len(voc.level_desc) == 4
    txt = vocabulary({"file": "orbslam3_tpu_torch/data/euroc_loop_vocab.txt"}, None, "cpu")
    assert len(txt.level_desc) == txt.levels >= 1
    with pytest.raises(ValueError, match="npz or .txt"):
        vocabulary({"file": "BENCHMARK.json"}, None, "cpu")
