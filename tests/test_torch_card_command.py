"""The command that runs the card's parity tests (chip_smoke.CARD_TEST_ARGS
on chip_smoke.CARD_TEST_FILES, as README gives it) collects every gpu-marked
case of those files where JAX cannot be imported, as on the card's machine,
and the same cases as where JAX is installed."""
import importlib.util
import os
import subprocess
import sys

pytest_plugins = ["torch_watchdog"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_TESTS = {"test_kernels_on_card", "test_brief_kernel_on_card",
             "test_brief_raw_kernel_on_card", "test_patches_kernel_on_card",
             "test_runtime_window_kernels_on_card",
             "test_stream_on_card_matches_cpu",
             "test_bootstrap_schur_matches_float64",
             "test_revisit_on_card_matches_cpu"}


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    return _module("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


def _collect(pythonpath):
    c = _chip_smoke()
    env = dict(os.environ, PYTHONPATH=pythonpath)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only",
         *c.CARD_TEST_ARGS, *c.CARD_TEST_FILES], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    ids = [line for line in proc.stdout.splitlines() if "::" in line]
    return proc, ids


def test_card_tests_collect_without_jax(tmp_path):
    """A `jax` package that raises on import, first on the path: the
    collection still succeeds, and holds every gpu case and nothing else
    (1 in test_torch_klt.py, 2 in test_torch_brief.py and one per window
    of its PATCH_CARD_WINS, one per point of
    test_torch_klt_domain.CARD_POINTS, 2 in test_torch_stream_card.py, 1
    in test_torch_interactive_revisit_card.py)."""
    stub = tmp_path / "jax"
    stub.mkdir()
    (stub / "__init__.py").write_text(
        "raise ImportError('jax is not installed on the card machine')\n")
    proc, ids = _collect(f"{tmp_path}{os.pathsep}{ROOT}")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "error" not in proc.stdout.lower(), proc.stdout
    assert {i.split("::")[1].split("[")[0] for i in ids} == GPU_TESTS
    with_jax, ids_jax = _collect(ROOT)
    assert with_jax.returncode == 0, with_jax.stdout + with_jax.stderr
    assert ids == ids_jax
    domain = _module("card_points", os.path.join(
        ROOT, "tests", "test_torch_klt_domain.py"))
    brief = _module("patch_wins", os.path.join(
        ROOT, "tests", "test_torch_brief.py"))
    n_domain = sum("test_torch_klt_domain.py" in i for i in ids)
    n_brief = sum("test_torch_brief.py" in i for i in ids)
    assert n_domain == len(domain.CARD_POINTS)
    assert n_brief == 2 + len(brief.PATCH_CARD_WINS)
    assert sum("test_torch_stream_card.py" in i for i in ids) == 2
    assert sum("test_torch_interactive_revisit_card.py" in i
               for i in ids) == 1
    assert len(ids) == 1 + n_brief + n_domain + 2 + 1
