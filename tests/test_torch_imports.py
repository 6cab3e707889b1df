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
            "examples.planar_planning"):
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
