"""The PyTorch port never imports JAX, directly or through the JAX
package."""

import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "gaussianvi_tpu_torch"

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None            # any `import jax` now raises
import importlib, pkgutil
import gaussianvi_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for new in ("ops.psd", "kernels.fused_moments", "parallel.collective",
            "parallel.sharding", "parallel.multiprocess", "parallel.restarts",
            "factors.sdf", "factors.sdf_io", "factors.robots",
            "examples.planar_planning", "examples.ltv_estimation",
            "examples.plot_1d", "inference.introspect",
            "inference.validate", "utils.checkpoint", "utils.recorder",
            "utils.profiling", "ops.parallel_chain", "parallel.chain_seqpar",
            "parallel.time_sharding", "parallel.comm_model",
            "parallel.scaling_bench", "quadrature.gauss_hermite",
            "quadrature.smolyak", "quadrature.table", "quadrature.native",
            "quadrature.cli", "samplers.target", "samplers.hmc",
            "samplers.nuts", "samplers.smc", "samplers.diagnostics",
            "samplers.validate", "samplers._draws"):
    assert pkg.__name__ + "." + new in names, new
assert not any(m == "gaussianvi_tpu" or m.startswith("gaussianvi_tpu.")
               for m in sys.modules), "the JAX package was imported"
print(len(names))
"""


def test_every_module_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 26


def test_no_source_mentions_jax_imports():
    offenders = [
        str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
        if "import jax" in p.read_text()
        or "from gaussianvi_tpu " in p.read_text()
        or "from gaussianvi_tpu." in p.read_text()
        or "import gaussianvi_tpu\n" in p.read_text()
    ]
    assert not offenders, offenders


# the JAX package's subpackages the port carries over, and the names of
# their ``__all__`` it does not (the orbax checkpoint pair: the JAX
# package's checkpoint library, ROADMAP.md "Not carried over")
PORTED = ("", ".examples", ".factors", ".ops", ".inference", ".utils",
          ".parallel", ".quadrature", ".samplers")
NOT_CARRIED = {".utils": {"save_checkpoint_orbax", "load_checkpoint_orbax"}}


def _jax_names():
    import ast

    out = []
    for sub in PORTED:
        path = ROOT / "gaussianvi_tpu" / sub.strip(".") / "__init__.py"
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if (isinstance(node, ast.Assign)
                    and getattr(node.targets[0], "id", None) == "__all__"):
                names = ast.literal_eval(node.value)
        out += [(sub, n) for n in names
                if n not in NOT_CARRIED.get(sub, set())]
    return out


@pytest.mark.parametrize("sub,name", _jax_names())
def test_jax_public_name_imports_from_the_same_port_subpackage(sub, name):
    """Every name of a ported JAX subpackage's ``__all__`` (read from its
    source, without importing JAX) imports from the port's subpackage of
    the same name and is in its ``__all__``."""
    import importlib

    mod = importlib.import_module("gaussianvi_tpu_torch" + sub)
    assert hasattr(mod, name), f"gaussianvi_tpu_torch{sub} lacks {name}"
    assert name in mod.__all__
