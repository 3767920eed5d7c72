"""The port's JAX-free EuRoC fixture writer (orbslam3_tpu_torch/io/
euroc_fixture.py) against scripts/make_euroc_fixture.py::write_fixture on
fixture (i) of the EuRoC references (6 s at 10 Hz, scale 0.5, seed 7) and on
the first seconds of the revisit fixture: the same file tree, every yaml
and csv byte-equal, every PNG decoding to the same pixels (the compressed
bytes may differ: the port encodes with the standard library's zlib). Both
trees load through the port's EurocDataset with the same calibration."""
import filecmp
import os
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from orbslam3_tpu_torch.io.euroc import EurocDataset  # noqa: E402
from orbslam3_tpu_torch.io.euroc_fixture import write_fixture  # noqa: E402


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("kw", [dict(duration=6.0, hz=10.0, scale=0.5, seed=7),
                                dict(duration=4.0, hz=10.0, scale=0.5, seed=7, revisit=True)],
                         ids=["fixture_i", "revisit_head"])
def test_writer_matches_jax(tmp_path, kw):
    from make_euroc_fixture import write_fixture as jax_write

    a = jax_write(str(tmp_path / "jax"), **kw)
    b = write_fixture(str(tmp_path / "port"), **kw)
    files = tree(a)
    assert files == tree(b)
    n_png = 0
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            n_png += 1
            x, y = np.asarray(Image.open(pa)), np.asarray(Image.open(pb))
            assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape, rel
            np.testing.assert_array_equal(y, x, err_msg=rel)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), rel
    frames = int(round(kw["duration"] * kw["hz"]))
    assert n_png == 2 * frames
    ds_a, ds_b = EurocDataset(os.path.dirname(a)), EurocDataset(os.path.dirname(b))
    assert len(ds_a) == len(ds_b) == frames
    np.testing.assert_array_equal(ds_a.cam1.K, ds_b.cam1.K)
    assert ds_a.baseline == ds_b.baseline


def test_writer_workers_write_the_same_files(tmp_path):
    """Rendering in spawned processes writes the same bytes."""
    kw = dict(duration=1.0, hz=10.0, scale=0.25, seed=3)
    a = write_fixture(str(tmp_path / "one"), **kw)
    b = write_fixture(str(tmp_path / "two"), workers=2, **kw)
    files = tree(a)
    assert files == tree(b) and len(files) > 20
    for rel in files:
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel), shallow=False), rel
