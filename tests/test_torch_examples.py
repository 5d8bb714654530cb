"""The port's examples (`otmb_tpu_torch.examples`) against the JAX package's
(`examples/`), on the CPU at the JAX examples' sizes and seeds.

Each pair runs in this process: the port's `main(device="cpu")`, which
returns its printed numbers, and the JAX example's `main()` with its
stdout captured. The printed lines must match line by line once their
numbers are masked; the numbers are compared at full precision, the JAX
side's recorded from the `otmb_tpu` functions its example calls (wrapped
for the run), and its κ_h parsed from its output.

Two kinds of printed number are not compared in value: conservation
timescales at the rounding floor (a diffusive leg's, and the volume
conservation of the operator with bolus transports: their exact values
are infinite, each package's rounding sets them, so both are only held
above 1e5 Myr, the reference's invariant), and the fractions' solve
residuals, which each engine reads at its own cadence.

The band shares are held at 1e-6 to the JAX package's
`water_mass_fractions` solved to tol 1e-14 on the example's operator.
The JAX example's own iterate at its tol 1e-12 is 3.3e-6 from those
converged shares (its relative residual, the surface rows', leaves the
interior unresolved: the dye stopping rule), while the port's engine,
which reads its first chunk after 1, 2, 4, ... iterations, stops at
~3e-16; the example's printed shares are held at their printed
precision.
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

YR = 365.25 * 24 * 3600
MYR = 1e6 * YR
NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
# a number with the padding before it (%10.3g pads by the digits it drops)
PADDED = re.compile(r"\s*[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
TOL_DIAG = 1e-10  # diagnostics and ranges, relative
TOL_AGE = 1e-8  # mean ages, relative
TOL_SHARE = 1e-6  # band shares (fractions of the ocean volume)
TOL_KAPPA = 0.5  # recovered kappa_h, m^2/s
# A diffusive leg's timescale above this is at the rounding floor (the
# reference's invariant: >= 1e5 Myr).
ROUNDOFF_MYR = 1e5


def _record(monkeypatch, names):
    """Wrap `otmb_tpu.<name>` for each name so that its results are kept, in
    call order, and the arguments of each call under ("args", name)."""
    import otmb_tpu

    calls = {n: [] for n in names}
    calls.update({("args", n): [] for n in names})
    for n in names:
        fn = getattr(otmb_tpu, n)

        def wrapped(*args, _fn=fn, _n=n, **kwargs):
            out = _fn(*args, **kwargs)
            calls[_n].append(out)
            calls["args", _n].append((args, kwargs))
            return out

        monkeypatch.setattr(otmb_tpu, n, wrapped)
    return calls


def _run_both(name, monkeypatch, capsys, recorded, **port_kwargs):
    """(the port's dict and stdout, the JAX example's recorded calls and
    stdout)."""
    import importlib

    port = importlib.import_module(f"otmb_tpu_torch.examples.{name}")
    ref = importlib.import_module(f"examples.{name}")
    got = port.main(device="cpu", **port_kwargs)
    port_out = capsys.readouterr().out
    with monkeypatch.context() as m:
        calls = _record(m, recorded)
        ref.main()
    return got, port_out, calls, capsys.readouterr().out


def _same_lines(port_out: str, jax_out: str):
    mask = lambda text: [PADDED.sub(" #", line) for line in text.strip().splitlines()]
    assert mask(port_out) == mask(jax_out), (port_out, jax_out)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _same_timescale(mine: float, theirs: float, what: str):
    """Equal within TOL_DIAG, or both at the rounding floor."""
    if theirs > ROUNDOFF_MYR:
        assert mine > ROUNDOFF_MYR, what
    else:
        assert _rel(mine, theirs) <= TOL_DIAG, what


def _wet_mean(gamma, v3d, wet):
    g, v = np.asarray(gamma)[wet], np.asarray(v3d)[wet]
    return float((g * v).sum() / v.sum()) / YR


def test_end_to_end(monkeypatch, capsys):
    got, port_out, calls, jax_out = _run_both(
        "end_to_end", monkeypatch, capsys,
        ["makegridmetrics", "makeindices", "operator_diagnostics", "explicit_euler_propagate",
         "ideal_age", "sequestration_time"], grid_shape=(2, 2))
    _same_lines(port_out, jax_out)
    gm, idx = calls["makegridmetrics"][0], calls["makeindices"][0]
    wet = np.asarray(idx.wet3d)
    assert got["grid"] == (gm.topology.kind, tuple(gm.shape), int(idx.nwet))
    for (name, (tau_div, tau_vol)), d in zip(got["diagnostics"].items(),
                                             calls["operator_diagnostics"]):
        _same_timescale(tau_div, float(d["tau_div_s"]) / MYR, name)
        _same_timescale(tau_vol, float(d["tau_vol_s"]) / MYR, name)
    chi = np.asarray(calls["explicit_euler_propagate"][0])
    for mine, theirs in zip(got["range"], (chi[wet].min(), chi[wet].max())):
        assert _rel(mine, float(theirs)) <= TOL_DIAG
    for key, fn in (("ideal_age_yr", "ideal_age"), ("sequestration_yr", "sequestration_time")):
        assert _rel(got[key], _wet_mean(calls[fn][0][0], gm.v3d, wet)) <= TOL_AGE
    assert f"coarsened {got['coarsened'][0]} -> {got['coarsened'][1]} cells" in jax_out
    shape, delta = got["sharded"]
    assert shape == (2, 2) and delta <= 1e-12
    assert float(NUMBER.findall(jax_out.strip().splitlines()[-1])[-1]) <= 1e-12


def test_end_to_end_skips_the_grid_unasked(capsys):
    from otmb_tpu_torch.examples import end_to_end

    assert end_to_end._sharded(None, None, 0.0, None, torch.device("cpu"), None) is None


def test_water_masses(monkeypatch, capsys):
    from otmb_tpu import water_mass_fractions

    got, port_out, calls, jax_out = _run_both(
        "water_masses", monkeypatch, capsys,
        ["makegridmetrics", "makeindices", "water_mass_fractions"])
    _same_lines(port_out, jax_out)
    gm, idx = calls["makegridmetrics"][0], calls["makeindices"][0]
    fr, res = (np.asarray(a) for a in calls["water_mass_fractions"][0])
    v = np.nan_to_num(np.asarray(gm.v3d))
    share = lambda f: float((np.nan_to_num(np.asarray(f)) * v).sum() / v.sum())
    printed = [float(NUMBER.findall(line)[0]) for line in jax_out.splitlines()
               if line.strip().endswith(")") and "%" in line]
    np.testing.assert_allclose([100 * share(f) for f in fr], printed, rtol=0, atol=0.05)
    np.testing.assert_allclose([100 * x for x in got["shares"]], printed, rtol=0, atol=0.05)
    args, kwargs = calls["args", "water_mass_fractions"][0]
    converged, _ = water_mass_fractions(*args, **{**kwargs, "tol": 1e-14})
    np.testing.assert_allclose(got["shares"], [share(f) for f in converged], rtol=0,
                               atol=TOL_SHARE)
    assert max(got["residuals"]) <= 1e-12 and float(res.max()) <= 1e-12
    s = fr.sum(axis=0)[np.asarray(idx.wet3d)]
    for mine, theirs in zip(got["sum_range"], (s.min(), s.max())):
        assert abs(mine - float(theirs)) <= 1e-3


def test_density_pipeline(monkeypatch, capsys):
    got, port_out, calls, jax_out = _run_both(
        "density_pipeline", monkeypatch, capsys,
        ["rho_teos10", "potential_density_slopes", "operator_diagnostics", "redi_apply"])
    _same_lines(port_out, jax_out)
    rho = np.asarray(calls["rho_teos10"][0])
    s_i, s_j = (np.asarray(s) for s in calls["potential_density_slopes"][0])
    d = calls["operator_diagnostics"][0]
    want = {"rho": (np.nanmin(rho), np.nanmax(rho)),
            "slopes": (np.nanmax(np.abs(s_i)), np.nanmax(np.abs(s_j)))}
    for key, pair in want.items():
        for mine, theirs in zip(got[key], pair):
            assert _rel(mine, float(theirs)) <= TOL_DIAG, key
    _same_timescale(got["tau_vol_myr"], float(d["tau_vol_s"]) / MYR, "T with bolus")
    tchi = np.asarray(calls["redi_apply"][0])
    assert _rel(got["redi_max"], float(np.abs(tchi).max())) <= TOL_DIAG


def test_calibrate_kappa(monkeypatch, capsys):
    got, port_out, _, jax_out = _run_both("calibrate_kappa", monkeypatch, capsys, [])
    _same_lines(port_out, jax_out)
    kappas = [float(NUMBER.findall(line)[1]) for line in jax_out.splitlines()
              if line.startswith("iter")]
    assert len(kappas) == len(got["trace"])
    for (_, mine, _), theirs in zip(got["trace"], kappas):
        assert abs(mine - theirs) <= TOL_KAPPA
    recovered = float(NUMBER.findall(jax_out.strip().splitlines()[-1])[0])
    assert abs(got["kappa_h"] - recovered) <= TOL_KAPPA
    assert abs(got["kappa_h"] - 800.0) < 20.0


@pytest.mark.parametrize("name", ["end_to_end", "water_masses", "density_pipeline",
                                  "calibrate_kappa"])
def test_examples_need_a_device_or_cpu(name, monkeypatch):
    """Left out, `device` is the current CUDA device: without one, each
    example raises rather than run on the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"otmb_tpu_torch.examples.{name}").main()
