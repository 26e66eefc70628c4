"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; names are compared by their
top-level part, whole (``mustache_tpu_torch`` begins with
``mustache_tpu``)."""

from benchmark.harness import guard
from conftest import ROOT

BENCH = ROOT / "benchmark"


def _sources(path):
    return [p for p in path.rglob("*.py") if "__pycache__" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for p in _sources(BENCH):
        assert not guard.imported_names(p) & guard.FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources(BENCH / "reference"):
        names = guard.imported_names(p)
        assert guard.PROGRAM not in names and not names & guard.FORBIDDEN, p


def test_top_level_names_compare_whole():
    assert guard.loaded_forbidden({"mustache_tpu_torch": 1,
                                   "mustache_tpu_torch.cli": 1}) == []
    assert guard.loaded_forbidden({"mustache_tpu.config": 1,
                                   "jaxlib": 1}) == ["jaxlib", "mustache_tpu"]


def test_the_scan_sees_every_form(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom mustache_tpu.x import y\n"
                 "import importlib\nimportlib.import_module('flax')\n"
                 "from . import z\n")
    assert guard.imported_names(p) == {"jax", "mustache_tpu", "importlib",
                                       "flax"}
