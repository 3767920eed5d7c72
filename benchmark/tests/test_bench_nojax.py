"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (orbslam3_tpu_torch begins with
orbslam3_tpu); only the system drivers import the program, and the
reference imports nothing of it."""
import ast
import os
import subprocess
import sys

from slambench.manifest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "orbslam3_tpu"}
# the check's side: the reference, the generator and the arithmetic
REFERENCE = ["slambench/check.py", "slambench/stats.py", "slambench/synthetic.py",
             "slambench/traffic.py", "slambench/roofline.py", "slambench/reference/frontend.py"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _py(root):
    for d, _, files in os.walk(root):
        if "tests" in d.split(os.sep) or ".cache" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_forbidden_top_level_names():
    found = {}
    for root in (BENCH_DIR, ROOT / "orbslam3_tpu_torch"):
        for f in _py(root):
            bad = set(_imports(f)) & FORBIDDEN
            if bad:
                found[f] = bad
    assert not found
    # the comparison is of whole names
    assert "orbslam3_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for f in REFERENCE:
        assert "orbslam3_tpu_torch" not in set(_imports(BENCH_DIR / f)), f


def test_only_the_drivers_import_the_program():
    """The program is imported by slambench/systems.py and the driver files
    benchmark/systems/<system>.py, and by nothing else of the benchmark."""
    importers = {os.path.relpath(f, BENCH_DIR) for f in _py(BENCH_DIR)
                 if "orbslam3_tpu_torch" in set(_imports(f))}
    drivers = {os.path.join("systems", f) for f in os.listdir(BENCH_DIR / "systems")
               if f.endswith(".py")}
    assert importers <= {"slambench/systems.py"} | drivers, importers
    assert "systems/FusedSlam.py" in importers


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; "
            "import slambench.harness, slambench.manifest as m; m.load_driver('FusedSlam'); "
            "print(run.forbidden_modules())" % (str(BENCH_DIR), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={k: v for k, v in os.environ.items()
                                        if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_where_the_program_is_missing(tmp_path):
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "euroc_mh_vi.steady", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
