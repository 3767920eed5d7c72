"""The port's viewers against the JAX package's: `snapshot_data` of the
port's MapState equals the JAX copy's of the same map as numpy arrays
(exact, subsampling included), `render_page` is the same text for a static
and a live page, `save_html_view` writes the same file, and `LiveViewer`
serves its page and one published snapshot on a localhost port. Also
scripts/run_synthetic_torch.py on the CPU: its artifacts written, the
checkpoint loads back, the HTML embeds the run's map. And
scripts/view_checkpoint_torch.py on the CPU: from a checkpoint saved by the
port and one saved by the JAX package it writes pages that carry the same
points and keyframes, equal to the page scripts/view_checkpoint.py writes."""
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from orbslam3_tpu.viz import html_view as jhtml
from orbslam3_tpu_torch.map import slam_map as tsm
from orbslam3_tpu_torch.viz import html_view as thtml
from orbslam3_tpu_torch.viz.live import LiveViewer
import torch_parity  # noqa: F401  (one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    """A port MapState with random valid map points and keyframes, its
    numpy twin, a trajectory and ground truth."""
    rng = np.random.default_rng(0)
    st = tsm.empty_map(tsm.MapCapacity(max_kf=16, n_feat=32, max_mp=512, max_obs=4),
                       device="cpu")
    mp_valid = torch.from_numpy(rng.random(512) < 0.6)
    kf_valid = torch.from_numpy(rng.random(16) < 0.5)
    st = st._replace(mp_pos=torch.from_numpy(rng.normal(0, 2, (512, 3)).astype(np.float32)),
                     mp_valid=mp_valid, kf_valid=kf_valid,
                     kf_p=torch.from_numpy(rng.normal(0, 1, (16, 3)).astype(np.float32)))
    as_np = st._replace(**{f: getattr(st, f).numpy() for f in ("mp_pos", "mp_valid", "kf_valid",
                                                               "kf_p")})
    traj = rng.normal(0, 1, (40, 3)).astype(np.float32)
    gt = traj + rng.normal(0, 0.01, (40, 3)).astype(np.float32)
    return st, as_np, traj, gt


@pytest.mark.parametrize("max_points", [20000, 100])
def test_snapshot_equals_jax(scene, max_points):
    st, as_np, traj, gt = scene
    got = thtml.snapshot_data(st, torch.from_numpy(traj), gt, max_points=max_points)
    want = jhtml.snapshot_data(as_np, traj, gt, max_points=max_points)
    assert got == want
    assert len(got["points"]) == min(int(st.mp_valid.sum()), max_points)
    assert thtml.snapshot_data() == jhtml.snapshot_data()


@pytest.mark.parametrize("poll_ms", [None, 250])
def test_render_page_equals_jax(scene, poll_ms):
    data = jhtml.snapshot_data(scene[1], scene[2], scene[3])
    assert thtml.render_page(data, poll_ms) == jhtml.render_page(data, poll_ms)


def test_save_html_view_equals_jax(scene, tmp_path):
    st, as_np, traj, gt = scene
    a = thtml.save_html_view(str(tmp_path / "t.html"), st, traj, gt)
    b = jhtml.save_html_view(str(tmp_path / "j.html"), as_np, traj, gt)
    assert open(a).read() == open(b).read()


def test_live_viewer_serves_a_snapshot(scene):
    st, _, traj, gt = scene
    viewer = LiveViewer(port=0, min_interval_s=0.0)
    try:
        assert viewer.url.startswith("http://127.0.0.1:")
        page = urllib.request.urlopen(viewer.url + "/", timeout=10).read().decode()
        assert "const POLL_MS = 1000;" in page and "/state.json" in page
        empty = json.loads(urllib.request.urlopen(viewer.url + "/state.json", timeout=10).read())
        assert empty == dict(points=[], kf=[], traj=[], gt=[])
        assert viewer.publish(st, traj, gt)
        got = json.loads(urllib.request.urlopen(viewer.url + "/state.json", timeout=10).read())
        assert got == jhtml.snapshot_data(scene[1], traj, gt) and viewer.n_published == 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(viewer.url + "/nothing", timeout=10)
    finally:
        viewer.close()


def test_run_synthetic_torch(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from run_synthetic_torch import run

    from orbslam3_tpu_torch.map.checkpoint import load_map

    out = run(0.5, str(tmp_path), device="cpu")
    assert out["frames"] == 10 and out["keyframes"] >= 1 and out["device"] == "cpu"
    assert np.isfinite(out["ate_m"])
    for name in ("trajectory.tum", "groundtruth.tum", "map.ply", "checkpoint.npz", "map.html"):
        assert os.path.getsize(tmp_path / name) > 0, name
    assert np.loadtxt(tmp_path / "trajectory.tum").shape == (10, 8)
    m = load_map(str(tmp_path / "checkpoint.npz"), device="cpu")
    assert int(m.n_kf) == out["keyframes"]
    assert f'"points": [[' in open(tmp_path / "map.html").read()


def _page_data(path) -> dict:
    text = open(path).read()
    return json.loads(text.split("const DATA = ", 1)[1].split(";\n", 1)[0])


def test_view_checkpoint_torch(scene, tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import view_checkpoint as jview
    import view_checkpoint_torch as tview

    from orbslam3_tpu.map import checkpoint as jckpt
    from orbslam3_tpu_torch.map import checkpoint as tckpt

    st, _, traj, _ = scene
    port_ckpt, jax_ckpt = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tckpt.save_map(port_ckpt, st)
    jckpt.save_map(jax_ckpt, jckpt.load_map(port_ckpt))
    tum = tmp_path / "traj.tum"
    np.savetxt(tum, np.column_stack([np.arange(len(traj)), traj, np.tile([0, 0, 0, 1],
                                                                          (len(traj), 1))]))
    pages = {}
    for name, ckpt in (("port", port_ckpt), ("jax", jax_ckpt)):
        pages[name] = str(tmp_path / f"{name}.html")
        assert tview.main([ckpt, pages[name], str(tum), "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["view_checkpoint.py", jax_ckpt,
                                      str(tmp_path / "ref.html"), str(tum)])
    assert not jview.main()
    port, jax_saved, ref = (_page_data(p) for p in (pages["port"], pages["jax"],
                                                   tmp_path / "ref.html"))
    assert len(port["points"]) == len(jax_saved["points"]) == int(st.mp_valid.sum())
    assert len(port["kf"]) == len(jax_saved["kf"]) == int(st.kf_valid.sum())
    assert len(port["traj"]) == len(traj)
    assert open(pages["jax"]).read() == open(tmp_path / "ref.html").read()
    assert port == ref
