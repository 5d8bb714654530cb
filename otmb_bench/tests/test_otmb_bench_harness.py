"""The harness end to end at a size a test run holds (24x16x8, tripolar),
with each cell's own limits: the program's run is correct, the control's
is not, and a run with the timed path broken underneath is not, once for
each fault the cell can have (a step that leaves its state unchanged, half
of a batch left out and filled with the mean of the rest, an answer
altered where it is produced: one value doubled, or all zeroed with the
program's own residuals kept; no cell exchanges between chips). Then the
modules a run loads, and a run without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

import otmb_tpu_torch as P
from otmb_bench import run as R
from otmb_bench import spec as S
from otmb_tpu_torch.models import solvers
from otmb_tpu_torch.ops import stencil

CELLS = [w["name"] for w in S.benchmark()["workloads"]]
ROOT = S.ROOT
SEED = 2**31 + 12345  # larger than 32 signed bits hold


def tiny(cell: str) -> S.Spec:
    sp = S.load(cell)
    sp.config = dict(sp.config, grid={"nx": 24, "ny": 16, "nz": 8})
    if sp.traffic["entry"] == "fixed_cycles":
        # at this size the cell's cycles would reach the float32 floor, where
        # the reported residual is rounding: one cycle, far from it
        sp.traffic = dict(sp.traffic, maxiter=2)
    return sp


def run(cell: str, device="cpu", control=False) -> dict:
    torch.set_num_threads(1)
    return R.run(tiny(cell), SEED, 0.2, False, torch.device(device), control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(S.load(cell).workload["limits"]) | {"failed"}


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not(cell, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run(cell, device, control=True)
    assert not res["correct"], res["checks"]


def _unchanged_state(monkeypatch, cell):
    monkeypatch.setattr(solvers, "_bicgstab_steps", lambda sys_, st, n: st)
    monkeypatch.setattr(solvers, "_bicgstab2_cycles", lambda sys_, step, st, n: st)
    monkeypatch.setattr(stencil, "_plain", lambda coeffs, chi, topology, dt: chi)


def _half_batch(monkeypatch, cell):
    def halve(fn):
        def wrapped(coeffs, xs, *a, **k):
            h = xs.shape[0] // 2
            out = fn(coeffs, xs[:h], *a, **k)
            got = out[0] if isinstance(out, tuple) else out
            full = torch.cat([got, got.mean(0, keepdim=True).expand_as(got)[: xs.shape[0] - h]])
            return (full, torch.cat([out[1], out[1][: xs.shape[0] - h]])) if isinstance(
                out, tuple) else full
        return wrapped

    monkeypatch.setattr(solvers, "solve_shifted_multi", halve(solvers.solve_shifted_multi))
    monkeypatch.setattr(P, "euler_propagate_multi", halve(P.euler_propagate_multi))


def _altered_answer(monkeypatch, cell):
    def alter(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            x = out[0] if isinstance(out, tuple) else out
            flat = x.view(-1)
            wet = torch.nonzero(torch.isfinite(flat) & (flat != 0)).view(-1)
            j = int(wet[len(wet) // 2])
            flat[j] = 2 * flat[j]
            return out
        return wrapped

    for name in ("ideal_age", "water_mass_fractions", "solve_shifted_chunked",
                 "euler_propagate_multi"):
        monkeypatch.setattr(P, name, alter(getattr(P, name)))


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}
BATCHED = {"esm1deg.fractions4", "om2qdeg.propagate8"}


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in sorted(FAULTS)
                                         if f != "half_batch" or c in BATCHED])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, cell)
    res = run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_zero_answer_with_its_claims_kept_is_not_correct(cell, monkeypatch):
    """The answer zeroed where it is produced, the reported residuals kept:
    the comparison with the reference alone has to see it (a zero age is a
    state left unchanged from the solver's start)."""

    def zero(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            x = out[0] if isinstance(out, tuple) else out
            x.copy_(torch.where(torch.isfinite(x), 0.0, x))
            return out
        return wrapped

    for name in ("ideal_age", "water_mass_fractions", "solve_shifted_chunked",
                 "euler_propagate_multi"):
        monkeypatch.setattr(P, name, zero(getattr(P, name)))
    res = run(cell)
    assert res["failed"] == 0, res["checks"]
    assert not res["correct"], res["checks"]


FORBIDDEN = {"jax", "jaxlib", "flax", "otmb_tpu"}
PROBE = """
import json, sys, torch
from otmb_bench import run as R, spec as S, readings
for w in S.benchmark()["workloads"]:
    sp = S.load(w["name"])
    S.entry(sp.traffic)
    for m in sp.end_to_end + sp.per_layer:
        S.reader(m["name"])
sp = S.load("esm1deg.age")
sp.config = dict(sp.config, grid={"nx": 24, "ny": 16, "nz": 8})
R.run(sp, 1, 0.05, False, torch.device("cpu"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
PURE = """
import json, sys
import otmb_bench.reference, otmb_bench.case, otmb_bench.check, otmb_bench.roofline
import otmb_bench.window, otmb_bench.readers, otmb_bench.spec
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str) -> set:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    names = _top_level(PROBE)
    assert not names & FORBIDDEN  # whole names: otmb_tpu_torch is not otmb_tpu
    assert "otmb_tpu_torch" in names and "otmb_bench" in names
    pure = _top_level(PURE)
    assert "otmb_tpu_torch" not in pure and not pure & FORBIDDEN


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "otmb_tpu_torch_extra", sys)
    assert "otmb_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "otmb_tpu.models", sys)
    assert "otmb_tpu" in R.forbidden_modules()


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "-m", "otmb_bench.run", "--workload", "esm1deg.age",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
