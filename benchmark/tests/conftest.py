"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of the checkout (CPU), and on a card
`python -m pytest benchmark/tests -m gpu`.

Tests that need the card carry the `gpu` marker and decide inside a
fixture whether there is one."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU (skips without a CUDA device)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.fixture(scope="session")
def render_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("render")


def tiny(config_name: str, traffic_name: str, limits: str = "tiny_limits") -> dict:
    """A run's resolved inputs for a CPU-sized configuration of the tests'
    data folder, under a traffic mix of the benchmark's."""
    import json

    def rd(path):
        with open(path) as f:
            return json.load(f)

    lim = rd(os.path.join(HERE, "data", f"{limits}.json"))
    cfg = rd(os.path.join(HERE, "data", f"{config_name}.json"))
    if cfg["system"] != "FusedSlam":
        lim = {k: v for k, v in lim.items() if k != "gravity_err_deg"}
    return {"config": cfg, "traffic": rd(os.path.join(BENCH, "traffic", f"{traffic_name}.json")),
            "cell": {"limits": lim},
            "metrics": [{"name": n, "unit": "x"} for n in ("tracked_fps", "setup_s")]}
