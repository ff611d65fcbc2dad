"""Device-facing tooling that a CPU run can still check: the compile-cache
location, the published-peaks table, and the refusal of the GPU entry
points to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from navier_stokes_tpu.utils.compile_cache import REPO_CACHE_DIR, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert enable_compile_cache() == REPO_CACHE_DIR
    assert REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == REPO_CACHE_DIR


def test_device_peaks_h100():
    import bench

    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12


def test_device_peaks_unknown_kind_raises():
    import bench

    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"ok"' not in r.stdout  # no result line


def _gpu_case():
    import jax.numpy as jnp
    import numpy as np

    from navier_stokes_tpu.fem.dofs import make_dofs, renumber_blocked
    from navier_stokes_tpu.mesh.generate import unit_square
    from navier_stokes_tpu.ops.windowed import build_windowed_layout

    dofs, bi = renumber_blocked(make_dofs(unit_square(12)), cells_per_block=32)
    lay = build_windowed_layout(
        dofs.cell_vdofs, dofs.cell_pdofs, dofs.n_vs, dofs.n_ps, 2, block_info=bi
    )
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((lay.nl, lay.nli, lay.ncd)), jnp.float32)
    x = jnp.asarray(rng.standard_normal(dofs.n_total), jnp.float32)
    return lay, A, x


def _rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.gpu
def test_windowed_matvec_on_gpu_matches_plain(gpu_device):
    """The f32 matvec on the card (the one-pass kernel) against the plain
    gather / contract / scatter-add path on the card: f32 rounding only."""
    from navier_stokes_tpu.ops.windowed import windowed_matvec, windowed_matvec_block

    lay, A, x = _gpu_case()
    text = jax.jit(windowed_matvec).lower(lay, A, x).as_text()
    assert "windowed_matvec_onepass" in text
    y = jax.jit(windowed_matvec)(lay, A, x)
    assert _rel(y, jax.jit(windowed_matvec_block)(lay, A, x)) < 1e-6


@pytest.mark.gpu
def test_windowed_matvec_sharded_on_gpu(gpu_device):
    """The kernel inside shard_map with a halo axis (a one-card mesh: the
    halo exchange degenerates to zeros at both ends) matches one device."""
    from jax.sharding import PartitionSpec as P

    from navier_stokes_tpu.ops.windowed import windowed_matvec
    from navier_stokes_tpu.parallel import windowed_spmd as wspmd
    from navier_stokes_tpu.parallel.spmd import device_mesh, shard_map

    lay, A, x = _gpu_case()
    dl = wspmd.make_dist_layout(lay, 1)
    mesh = device_mesh(1, axis=wspmd.AXIS)
    lay_s = wspmd.shard_layout(lay, dl, mesh)
    f = shard_map(
        lambda la, a, v: windowed_matvec(la, a, v, axis_name=wspmd.AXIS),
        mesh,
        in_specs=(wspmd.layout_pspecs(lay_s), P(None, None, wspmd.AXIS), P(wspmd.AXIS)),
        out_specs=P(wspmd.AXIS),
    )
    y = jax.jit(f)(lay_s, A, wspmd.to_dist(x, dl))
    assert _rel(wspmd.from_dist(y, dl), jax.jit(windowed_matvec)(lay, A, x)) < 1e-6
