"""scripts/eval_suite_torch.py against the JAX package's scripts/eval_suite.py.

(a) The port's `_get_world` builds the same worlds as JAX's for every world
kind (hard, easy, extrinsics, revisit): the same configuration, frame times
and IMU windows, and the same rendered frames bit for bit at the first
frames, the last and, on the revisit world, one inside its blackout.
(b) One short run_config on the CPU (SMALL of scripts/make_eval_reference.py:
seed 11, stereo-inertial, 1.6 s, 32 frames at 752x480, chunk 8) against the
JAX record's small entry in orbslam3_tpu_torch/data/eval_reference.json:
the first and the last frame's checksums, keyframes and imu_init exact, ATE
and RPE within 5 mm. (c) The table main() writes from fixed rows is the
table the JAX script writes into BASELINE.md, but for the script's name."""
import io
import json
import os
import sys

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import eval_suite as jsuite  # noqa: E402
import eval_suite_torch as tsuite  # noqa: E402
import make_eval_reference  # noqa: E402
from orbslam3_tpu.io.synthetic import SyntheticWorld as JWorld  # noqa: E402
from orbslam3_tpu_torch.io.synthetic import SyntheticWorld as TWorld  # noqa: E402

KINDS = {"hard": "stereo", "easy": "inertial_easy", "extrinsics": "extrinsics",
         "revisit": "revisit_loop"}


def _first_frames(world_cls, monkeypatch):
    """Render only frames 0, 1, the last and the first inside a blackout."""
    render = world_cls.render_sequence

    def some(self, times, blackout=None, workers=0):
        idx = [0, 1, len(times) - 1]
        if blackout is not None:
            idx.append(int(np.searchsorted(times, blackout[0])))
        return render(self, [times[i] for i in idx], blackout=blackout, workers=1)

    monkeypatch.setattr(world_cls, "render_sequence", some)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_get_world_renders_the_jax_world(kind, monkeypatch):
    mode = KINDS[kind]
    monkeypatch.setattr(jsuite, "_WORLD_CACHE", {})
    monkeypatch.setattr(tsuite, "_WORLD_CACHE", {})
    _first_frames(JWorld, monkeypatch)
    _first_frames(TWorld, monkeypatch)
    jw, jt, jf, jimu = jsuite._get_world(23, 8.0, mode)
    tw, tt, tf, timu = tsuite._get_world(23, 8.0, mode)
    assert tsuite.world_key(23, 8.0, mode) == (kind, 23, 24.0 if kind == "revisit" else 8.0)
    assert tw.cfg._asdict() == jw.cfg._asdict()
    np.testing.assert_array_equal(tt, jt)
    assert len(tf) == len(jf) == (4 if kind == "revisit" else 3)
    for (tl, tr), (jl, jr) in zip(tf, jf):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
    if kind == "revisit":
        assert tf[-1][0].std() == 0  # the blackout's flat gray
    assert len(timu) == len(jimu) == len(tt)
    for i in (1, len(tt) // 2, len(tt) - 1):
        for a, b in zip(timu[i], jimu[i]):
            np.testing.assert_array_equal(a, b)


def test_small_run_matches_the_jax_record():
    ref = tsuite.load_reference()["small"]
    small = make_eval_reference.SMALL
    assert (ref["seed"], ref["mode"], ref["duration_s"]) == (small["seed"], small["mode"],
                                                           small["duration"])
    # rendered here with two workers; run_slam takes the world from the cache
    frames = tsuite._get_world(small["seed"], small["duration"], small["mode"], workers=2)[2]
    slam, row = tsuite.run_slam(small["seed"], small["duration"], small["mode"], chunk=8,
                                device="cpu")
    rec = tsuite.port_record(slam, frames)
    msg = f"port {row}, JAX {ref}; first departure: {tsuite.first_departure(rec, ref)}"
    assert rec["checksum"] == ref["checksum"]
    assert rec["n_frames"] == ref["n_frames"] == 32
    assert row["keyframes"] == ref["keyframes"] and row["imu_init"] == ref["imu_init"], msg
    assert rec["imu_init_frame"] == ref["imu_init_frame"], msg
    assert abs(row["ate_m"] - ref["ate_m"]) <= 5e-3, msg
    assert abs(row["rpe_m"] - ref["rpe_m"]) <= 5e-3, msg
    assert rec["ok_frac"] >= ref["ok_frac"] - 0.05, msg


def _fixed_rows(seed, duration, mode, chunk=8, **_):
    k = tsuite.MODES.index(mode)
    return dict(seed=seed, mode=mode, ate_m=0.01 * seed + 1e-3 * k, rpe_m=0.002 * seed + 1e-4 * k,
                rpe_rad=None if mode == "revisit" else 1e-3 * seed, fps=1.5 + 0.1 * k + seed / 100,
                keyframes=20 + seed, imu_init=None if mode == "stereo" else seed != 11,
                loops=seed % 3 if mode in tsuite.LOOP_MODES else None)


def test_table_matches_the_jax_format(monkeypatch, tmp_path, capsys):
    seeds, modes = "7,11,23", "stereo,inertial,loop,revisit,revisit_loop"
    # the JAX script, its rows fixed, BASELINE.md read empty and its write caught
    written = []

    class Caught(io.StringIO):
        def write(self, text):
            written.append(text)
            return len(text)

    def fake_open(path, mode="r"):
        return Caught() if "w" in mode else io.StringIO("")

    monkeypatch.setattr(jsuite, "run_config", _fixed_rows)
    monkeypatch.setattr(jsuite, "open", fake_open, raising=False)
    monkeypatch.setattr(jsuite.os, "makedirs", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["eval_suite.py", "--cpu", "--seeds", seeds,
                                      "--modes", modes, "--duration", "8"])
    jsuite.main()
    jax_block = "".join(written).split(jsuite.MARK_BEGIN)[1].split(jsuite.MARK_END)[0]
    # the port's main, its rows fixed the same way, the table to --out
    monkeypatch.setattr(tsuite, "run_config", _fixed_rows)
    out = tmp_path / "table.md"
    assert tsuite.main(["--device", "cpu", "--seeds", seeds, "--modes", modes,
                        "--out", str(out)]) == 0
    port = out.read_text()
    want = jax_block.replace("scripts/eval_suite.py", "scripts/eval_suite_torch.py")
    assert port.strip("\n").split("\n") == want.strip("\n").split("\n")
    assert "backend cpu" in port and port.count("\n| ") == 6
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(rows) == 2 * 15 and rows[:15] == rows[15:]  # both printed the same rows
