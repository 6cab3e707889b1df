"""PyTorch port, the quadrature generator (``quadrature/{gauss_hermite,
smolyak,table,native,cli}.py``) against the JAX package: the 1-D and
tensor-grid rules and the Smolyak rules bit for bit, ``get_rule`` for full
grids and rules beyond the committed table, table I/O across packages,
``verify_table`` holding the port's generator to the committed artifact,
the native C++ generator built into the port's own build directory, and
the command-line tools' output.  The committed table and the JAX
package's tree are only read: the last test holds the table's hash."""

import hashlib
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from gaussianvi_tpu import quadrature as jq  # noqa: E402
from gaussianvi_tpu.quadrature import cli as jcli  # noqa: E402
from gaussianvi_tpu_torch import quadrature as tq  # noqa: E402
from gaussianvi_tpu_torch.quadrature import cli as tcli  # noqa: E402
from gaussianvi_tpu_torch.quadrature import native, table  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "gaussianvi_tpu", "quadrature", "data",
                         "sparse_gh_table.npz")


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


COMMITTED_SHA = _sha256(COMMITTED)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("degree", range(1, 26))
def test_gauss_hermite_rules_bit_equal(degree):
    """gh_1d, gh_1d_half and the tensor grids (dims 1-3, up to 20,000
    nodes) are JAX's arrays bit for bit."""
    _same(tq.gh_1d(degree), jq.gh_1d(degree))
    _same(tq.gh_1d_half(degree), jq.gh_1d_half(degree))
    for dim in (1, 2, 3):
        if degree**dim <= 20_000:
            _same(tq.gh_tensor_grid(degree, dim), jq.gh_tensor_grid(degree, dim))


@pytest.mark.parametrize("dim,k", [(5, 2), (6, 3), (10, 3), (20, 2), (3, 19)])
def test_sparse_gh_bit_equal(dim, k):
    _same(tq.sparse_gh(dim, k), jq.sparse_gh(dim, k))


@pytest.mark.parametrize("dim,degree,kind", [
    (3, 4, "full"), (2, 25, "full"),     # tensor grids
    (3, 20, "sparse"),                   # beyond the schedule: generated
    (21, 2, "sparse"),                   # a dim the table lacks
    (4, 3, "sparse"),                    # a table hit
])
def test_get_rule_matches_jax(dim, degree, kind):
    _same(tq.get_rule(dim, degree, kind), jq.get_rule(dim, degree, kind))


def test_get_rule_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown quadrature kind"):
        tq.get_rule(2, 3, "lattice")


def test_schedule_matches_jax():
    assert tq.MAX_DEGREE_SCHEDULE == jq.MAX_DEGREE_SCHEDULE


def test_table_round_trip_across_packages(tmp_path):
    """save / load / build on a reduced schedule: the port's file reads
    back in both packages, JAX's file in the port, all bit for bit."""
    schedule = {1: 4, 2: 3, 5: 2}
    ours = tq.save_table(str(tmp_path / "port.npz"), schedule)
    theirs = jq.save_table(str(tmp_path / "jax.npz"), schedule)
    built = tq.build_table(schedule)
    assert built.keys() == jq.build_table(schedule).keys()
    want = {(d, k) for d, kmax in schedule.items() for k in range(1, kmax + 1)}
    for path in (ours, theirs):
        got, ref = tq.load_table(path), jq.load_table(path)
        assert set(got) == set(ref) == want
        for key in want:
            _same(got[key], ref[key])
            _same(got[key], (built[f"nodes_{key[0]}_{key[1]}"],
                             built[f"weights_{key[0]}_{key[1]}"]))
    nodes, weights = tq.load_table(ours)[(5, 2)]
    # ground truth (reference test_spgh_table_IO.cpp:64-78)
    assert nodes.shape == (11, 5)
    center = np.all(nodes == 0.0, axis=1)
    np.testing.assert_allclose(weights[center], [-4.0], atol=1e-9)


def test_verify_table_holds_the_committed_artifact(tmp_path):
    """The port's generator reproduces the table the JAX package wrote;
    a tampered copy fails."""
    assert table.TABLE_PATH == COMMITTED
    tq.verify_table()
    with np.load(COMMITTED) as data:
        entries = {k: data[k] for k in data.files}
    entries["weights_6_3"] = entries["weights_6_3"] * 1.001
    tampered = tmp_path / "tampered.npz"
    np.savez_compressed(tampered, **entries)
    with pytest.raises(AssertionError, match="dim=6, deg=3"):
        tq.verify_table(str(tampered))
    tq.verify_table(str(tampered), sample=[(5, 2)])


def test_the_port_never_writes_the_jax_tree(tmp_path):
    """save_table's default is the port's build directory; paths in the
    JAX package or csrc/ are refused before anything is built."""
    assert table.BUILD_TABLE.startswith(
        os.path.join(ROOT, "gaussianvi_tpu_torch", "_build") + os.sep)
    for path in (COMMITTED, os.path.join(ROOT, "csrc", "table.npz"),
                 os.path.join(ROOT, "gaussianvi_tpu", "new.npz")):
        with pytest.raises(ValueError, match="never writes"):
            tq.save_table(path, {1: 1})
    assert tq.save_table(str(tmp_path / "t.npz"), {1: 1}).endswith("t.npz")


@pytest.mark.parametrize("dim,k", [(1, 6), (2, 5), (5, 2), (6, 3), (10, 2)])
def test_native_generator_matches_numpy(dim, k):
    """The port's own copy of the C++ generator, built with g++ into
    ``gaussianvi_tpu_torch/_build/``, agrees with sparse_gh (the JAX
    package's tolerances)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native generator cannot be built")
    assert native.available()
    path = native.library_path()
    assert path.exists()
    assert str(path).startswith(
        os.path.join(ROOT, "gaussianvi_tpu_torch", "_build") + os.sep)
    assert native.SOURCE.samefile(
        os.path.join(ROOT, "gaussianvi_tpu_torch", "csrc", "spgh.cpp"))
    na, wa = native.sparse_gh_native(dim, k)
    nb, wb = tq.sparse_gh(dim, k)
    assert na.shape == nb.shape
    np.testing.assert_allclose(na, nb, atol=1e-13)
    np.testing.assert_allclose(wa, wb, atol=1e-12)
    n1, w1 = native.gh_1d_native(2 * k + 1)
    n0, w0 = tq.gh_1d(2 * k + 1)
    np.testing.assert_allclose(n1, n0, atol=1e-13)
    np.testing.assert_allclose(w1, w0, atol=1e-13)


def test_native_without_a_compiler_raises(monkeypatch, tmp_path):
    """No silent fallback: without the library the generators raise."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libspgh_missing.so")
    monkeypatch.setenv("PATH", "")
    native.load_library.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            native.sparse_gh_native(2, 3)
        with pytest.raises(RuntimeError, match="unavailable"):
            native.gh_1d_native(3)
    finally:
        native.load_library.cache_clear()


@pytest.mark.parametrize("argv", [
    ["show-rule", "2", "3"], ["show-rule", "5", "2"],
    ["sigmapts", "2", "3", "0.5", "2.0"], ["sigmapts", "3", "2", "-1", "0.1"],
    ["frobnicate"],
])
def test_cli_prints_what_jax_prints(argv, capsys):
    code = tcli.main(argv)
    ours = capsys.readouterr().out
    assert jcli.main(argv) == code
    assert capsys.readouterr().out == ours and ours


def test_cli_save_table(tmp_path, monkeypatch, capsys):
    """save-table writes where it is told, as JAX's does; without a path it
    writes the port's build directory, never the committed table."""
    path = str(tmp_path / "cli.npz")
    monkeypatch.setattr(tcli, "save_table",
                        lambda p: tq.save_table(p, {1: 2, 2: 2}))
    monkeypatch.setattr(jcli, "save_table",
                        lambda p: jq.save_table(p, {1: 2, 2: 2}))
    assert tcli.main(["save-table", path]) == 0
    ours = capsys.readouterr().out
    assert jcli.main(["save-table", path]) == 0
    assert ours == capsys.readouterr().out == f"saved quadrature table to {path}\n"
    assert set(tq.load_table(path)) == {(1, 1), (1, 2), (2, 1), (2, 2)}
    seen = []
    monkeypatch.setattr(tcli, "save_table", lambda p: seen.append(p) or p)
    assert tcli.main(["save-table"]) == 0
    assert seen == [table.BUILD_TABLE]
    assert tcli.main([]) == 1
    assert "python -m gaussianvi_tpu_torch.quadrature.cli" in capsys.readouterr().out


def test_committed_table_unchanged():
    """Runs last in this file: nothing above wrote the committed table."""
    assert _sha256(COMMITTED) == COMMITTED_SHA
    assert _sha256(COMMITTED) == _sha256(table.TABLE_PATH)
