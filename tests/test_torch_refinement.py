"""The refinement's revert rule (`solve_shifted_ir`): a pass that leaves the
f64 defect more than 1/0.9x the best one so far is undone, and the
refinement goes on from the best iterate with one retry (the JAX package
reverts only a pass that made the defect 4x worse). Such passes occur: on
an H100 the 0.25-degree f32 BiCGStab(2) age met one whose recurrence
residual drifted from the true one while the defect rose 2.3x
(scripts/quarter_robustness.py); without the revert, that pass ends the
refinement at 4.9e-2.
"""

import pytest
import torch

import otmb_tpu_torch as P
from otmb_tpu_torch.models import solvers as S

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    ds = P.synthetic_dataset(nx=18, ny=14, nz=6, topology="tripolar", seed=3)
    gm = P.makegridmetrics(areacello=ds.areacello, volcello=ds.volcello, lon=ds.lon,
                           lat=ds.lat, lev=ds.lev, lon_vertices=ds.lon_vertices,
                           lat_vertices=ds.lat_vertices, device="cpu")
    idx = P.makeindices(gm.v3d)
    T = P.assemble_transport(ds.umo, ds.vmo, ds.mlotst, gm, idx.wet3d).T
    surf = torch.zeros(idx.wet3d.shape, dtype=torch.float32)
    surf[0] = 1.0
    return T, gm.topology, idx.wet3d, torch.where(idx.wet3d, surf, 0.0)


@pytest.mark.parametrize("factor", [3.0, 4.5])
@pytest.mark.parametrize("inner", ["bicgstab2", "bicgstab"])
def test_a_pass_that_made_the_defect_worse_is_reverted_and_retried(case, inner, factor,
                                                                  monkeypatch):
    """The second inner solve returns `factor` times its correction, so its
    pass leaves the defect (factor - 1) times the start: 2x and 3.5x, under
    the JAX package's 4x. The next pass reverts to the best iterate, keeps
    its retry, and the refinement converges."""
    T, topo, wet, surf = case
    name = "solve_shifted" if inner == "bicgstab" else "solve_shifted_chunked"
    real = getattr(S, name)
    calls = {"n": 0}

    def overshoots(coeffs, b, topology, **kw):
        calls["n"] += 1
        x, res = real(coeffs, b, topology, **kw)
        return (factor * x if calls["n"] == 2 else x), res

    monkeypatch.setattr(S, name, overshoots)
    stats = {}
    _, rel = P.solve_shifted_ir(T.to(torch.float32), wet.float(), topo, extra_diag=surf,
                                tol=1e-9, max_refinements=12, inner_algorithm=inner,
                                stats=stats)
    passes = stats["passes"]
    assert passes[2]["reverted"] and "stagnated" not in passes[2]
    assert passes[2]["inner_iters"] > 0  # the retry ran
    # it starts from the best iterate (rounded to f32), not from the
    # overshot one, whose defect is (factor - 1) times pass 1's start
    assert passes[2]["rel_start"] <= 1.5 * passes[1]["rel_start"]
    assert rel < 1e-9
