"""The port's CLI (`python -m otmb_tpu_torch`) on the CPU: tests/test_cli.py's
round trip with `--device cpu`, operator files across the two packages'
CLIs, the two builds and ideal ages against each other, the exit codes
on a missed tol, the float64 fractions at their default tol, and the
demo as a module entry that never imports jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from otmb_tpu_torch.__main__ import main

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
REPO = str(Path(__file__).resolve().parents[1])


@pytest.fixture(scope="module")
def input_npz(tmp_path_factory):
    from otmb_tpu_torch.utils.synthetic import synthetic_dataset

    ds = synthetic_dataset(nx=24, ny=16, nz=8, topology="tripolar", seed=1)
    p = tmp_path_factory.mktemp("cli") / "in.npz"
    np.savez(
        p,
        areacello=np.asarray(ds.areacello), volcello=np.asarray(ds.volcello),
        lon=np.asarray(ds.lon), lat=np.asarray(ds.lat),
        lev=np.asarray(ds.lev),
        lon_vertices=np.asarray(ds.lon_vertices),
        lat_vertices=np.asarray(ds.lat_vertices),
        umo=np.nan_to_num(np.asarray(ds.umo)),
        vmo=np.nan_to_num(np.asarray(ds.vmo)),
        mlotst=np.asarray(ds.mlotst),
    )
    return p


@pytest.fixture(scope="module")
def operators(input_npz, tmp_path_factory):
    """The operator file of each package's `build` (f64: the JAX tests run
    with x64 on)."""
    from otmb_tpu.__main__ import main as jax_main

    d = tmp_path_factory.mktemp("ops")
    port, ref = d / "port.npz", d / "jax.npz"
    assert main(["build", str(input_npz), str(port)] + CPU) == 0
    assert jax_main(["build", str(input_npz), str(ref)]) == 0
    return {"port": port, "jax": ref}


def test_cli_pipeline(input_npz, tmp_path):
    op = tmp_path / "op.npz"
    assert main(["build", str(input_npz), str(op)] + CPU) == 0
    assert main(["diagnose", str(op)] + CPU) == 0

    age = tmp_path / "age.npz"
    assert main(["idealage", str(op), str(age), "--tol", "1e-10"] + CPU) == 0
    with np.load(age) as d:
        gamma = d["ideal_age_seconds"]
    assert np.isfinite(gamma[np.isfinite(gamma)]).all()

    fr = tmp_path / "fr.npz"
    assert main(["fractions", str(op), str(fr), "--bands", "3", "--tol", "1e-10"] + CPU) == 0
    with np.load(fr) as d:
        fracs = d["fractions"]
        assert fracs.shape[0] == 3
        np.testing.assert_array_equal(d["band_edges"], [0, 5, 10, 16])
        s = np.nansum(fracs, axis=0)
        wet = np.isfinite(fracs[0])
        # partition of unity up to the surface-divergence imbalance
        assert abs(float(np.nanmean(s[wet])) - 1.0) < 1e-2


def test_builds_agree(operators):
    from otmb_tpu_torch.utils.checkpoint import load_operator

    port, topo, extras = load_operator(operators["port"], device="cpu")
    ref, topo_ref, extras_ref = load_operator(operators["jax"], device="cpu")
    assert topo == topo_ref
    np.testing.assert_array_equal(extras["wet3d"], extras_ref["wet3d"])
    np.testing.assert_allclose(extras["v3d"], extras_ref["v3d"], rtol=1e-12)
    for name, a, b in zip(port._fields, port, ref):
        assert a.dtype == b.dtype == torch.float64, name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale, name


@pytest.mark.parametrize("built_by", ["port", "jax"])
def test_operator_files_load_in_both_clis(operators, built_by, tmp_path):
    from otmb_tpu.__main__ import main as jax_main

    op = str(operators[built_by])
    assert main(["diagnose", op] + CPU) == 0
    assert jax_main(["diagnose", op]) == 0
    port_age, jax_age = tmp_path / "port_age.npz", tmp_path / "jax_age.npz"
    assert main(["idealage", op, str(port_age), "--tol", "1e-10"] + CPU) == 0
    assert jax_main(["idealage", op, str(jax_age), "--tol", "1e-10"]) == 0
    with np.load(port_age) as a, np.load(jax_age) as b:
        got, want = a["ideal_age_seconds"], b["ideal_age_seconds"]
    wet = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), wet)
    np.testing.assert_allclose(got[wet], want[wet], rtol=1e-8)


@pytest.mark.parametrize("adjoint", [False, True])
def test_idealage_exit_code_follows_tol(operators, adjoint, tmp_path):
    """Exit 0 only when the returned residual meets --tol (the reference
    exits 0 below a fixed 1e-6)."""
    op, out = str(operators["port"]), str(tmp_path / "age.npz")
    extra = ["--adjoint"] if adjoint else []
    assert main(["idealage", op, out, "--refine", "--tol", "1e-10"] + extra + CPU) == 0
    with pytest.warns(UserWarning, match="stagnated"):
        assert main(["idealage", op, out, "--refine", "--tol", "1e-20"] + extra + CPU) == 1


def test_fractions_defaults_converge(operators, tmp_path, capsys):
    """At its defaults (float64, tol 1e-12) every band converges, the note
    says why the tol is tight, and the fractions are a partition of one."""
    from otmb_tpu_torch.utils.checkpoint import load_operator, save_operator

    # an f32 operator file is widened to f64 for the solve
    coeffs, topo, extras = load_operator(operators["port"], device="cpu")
    op32 = tmp_path / "op32.npz"
    save_operator(op32, coeffs.to(torch.float32), topo, **extras)
    for op in (operators["port"], op32):
        out = tmp_path / "fr.npz"
        assert main(["fractions", str(op), str(out)] + CPU) == 0
        text = capsys.readouterr().out
        assert "note: tol 1e-12" in text and "dye stopping rule" in text
        residuals = [float(line.rsplit("residual", 1)[1]) for line in text.splitlines()
                     if line.startswith("band ")]
        assert len(residuals) == 3 and max(residuals) <= 1e-12
        with np.load(out) as d:
            fracs = d["fractions"]
        assert fracs.dtype == np.float64
        wet = np.isfinite(fracs[0])
        s = fracs.sum(axis=0)[wet]
        assert float(np.abs(s - 1.0).max()) <= 1e-3


def test_fractions_exit_code_follows_tol(operators, tmp_path):
    out = str(tmp_path / "fr.npz")
    assert main(["fractions", str(operators["jax"]), out, "--tol", "1e-30"] + CPU) == 1


def test_demo_module_entry_imports_no_jax():
    """`python -m otmb_tpu_torch demo --device cpu` exits 0 and loads
    neither jax nor otmb_tpu (modules loaded before it, e.g. by a site
    hook, do not count)."""
    code = (
        "import runpy, sys; sys.path.insert(0, %r); before = set(sys.modules)\n"
        "sys.argv = ['otmb_tpu_torch', 'demo', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('otmb_tpu_torch', run_name='__main__', alter_sys=True)\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'otmb_tpu'))\n"
        "print('RC', rc, 'BAD', bad); sys.exit(1 if rc or bad else 0)\n" % REPO
    )
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ideal age" in out.stdout and "RC 0 BAD []" in out.stdout


@pytest.mark.parametrize("command", ["demo", "build", "diagnose", "idealage", "fractions"])
def test_cli_needs_a_device_or_cpu(operators, input_npz, command, tmp_path, monkeypatch):
    """Without --device every subcommand takes the current CUDA device, and
    without one it raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    op, out = str(operators["port"]), str(tmp_path / "out.npz")
    argv = {"demo": [], "build": [str(input_npz), out], "diagnose": [op],
            "idealage": [op, out], "fractions": [op, out]}[command]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command] + argv)
