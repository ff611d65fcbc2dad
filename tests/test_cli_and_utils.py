"""CLI driver smoke tests (in-process) and utils coverage."""

import json

import numpy as np
import pytest

from navier_stokes_tpu.__main__ import main as cli_main
from navier_stokes_tpu.config import SolverConfig
from navier_stokes_tpu.mesh.generate import unit_square
from navier_stokes_tpu.utils.timers import PhaseTimers


@pytest.fixture
def square_msh(tmp_path):
    """gmsh 2.2 file of the 10x10 unit square: the same mesh, tags 0-3 and
    node count as the reference's mesh-square-h0.100000.msh."""
    m = unit_square(10)
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(m.n_nodes)]
    lines += [f"{i + 1} {float(x)!r} {float(y)!r} 0" for i, (x, y) in enumerate(m.coords)]
    lines += ["$EndNodes", "$Elements", str(len(m.boundary_facets) + m.n_cells)]
    k = 1
    for (a, b), t in zip(m.boundary_facets, m.boundary_tags):
        lines.append(f"{k} 1 2 {t} {t} {a + 1} {b + 1}")
        k += 1
    for c in m.cells:
        lines.append(f"{k} 2 2 10 10 {c[0] + 1} {c[1] + 1} {c[2] + 1}")
        k += 1
    lines.append("$EndElements")
    path = tmp_path / "mesh-square-h0.100000.msh"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_cli_info(capsys, square_msh):
    rc = cli_main(["info", "--mesh", square_msh])
    assert rc == 0
    out = capsys.readouterr().out
    assert "nodes=121" in out and '"n_total": 1003' in out


def test_cli_run(tmp_path, capsys, square_msh):
    cfg = {
        "inlet_tags": [0], "neumann_tags": [1], "wall_tags": [2, 3],
        "nu": 0.04, "p_out": 10.0, "T": 0.05, "dt": 0.05,
        "krylov": {"max_iters": 500},
    }
    cfgfile = tmp_path / "cfg.json"
    cfgfile.write_text(json.dumps(cfg))
    rc = cli_main([
        "run",
        "--mesh", square_msh,
        "--config", str(cfgfile),
        "--output-dir", str(tmp_path / "out"),
        "--log-json", str(tmp_path / "log.json"),
    ])
    assert rc == 0
    assert (tmp_path / "out" / "output-0001.h5").exists()
    records = json.loads((tmp_path / "log.json").read_text())
    assert any(r.get("event") == "newton" for r in records)
    out = capsys.readouterr().out
    assert "Newton iteration" in out


def test_cli_stokes(tmp_path, square_msh):
    rc = cli_main([
        "stokes",
        "--mesh", square_msh,
        "--output-dir", str(tmp_path),
        "--log-json", str(tmp_path / "log.json"),
    ])
    assert rc == 0
    assert (tmp_path / "output-0000.h5").exists()
    records = json.loads((tmp_path / "log.json").read_text())
    assert any(r.get("event") == "gmres" for r in records)


def test_config_roundtrip(tmp_path):
    cfg = SolverConfig()
    cfg.krylov.matvec = "windowed"
    d = cfg.to_dict()
    cfg2 = SolverConfig.from_dict(d)
    assert cfg2.krylov.matvec == "windowed"
    assert cfg2.inlet_tags == (11,)
    f = tmp_path / "c.json"
    f.write_text(json.dumps(d))
    cfg3 = SolverConfig.from_file(str(f))
    assert cfg3.nu == cfg.nu and cfg3.newton.tol == cfg.newton.tol


def test_phase_timers():
    import jax.numpy as jnp

    t = PhaseTimers()
    with t("work", jnp.zeros(10)):
        x = jnp.ones(1000).sum()
    with t("work"):
        float(x)
    assert t.counts["work"] == 2
    assert t.totals["work"] > 0
    assert "work" in t.report()
    assert t.as_dict()["work"]["calls"] == 2
