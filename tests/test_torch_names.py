"""Name parity: every public name of the JAX package has a counterpart in
the port, or stands on the list of names the port leaves out, each with
its reason (ROADMAP.md, "Do not port").

The JAX package is read with `ast` and never imported here, so no JAX
program is traced or compiled: each `__all__` of `otmb_tpu` and of its
subpackages, and every module's public top-level definitions (functions,
classes, assignments). The port's counterpart module (the same path, or
the one `RENAMED_MODULES` names) is imported and must hold each name, and
each `__all__` must hold the reference's.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "otmb_tpu"

#: Modules the port holds under another name: a Pallas module's kernel
#: moved to `csrc/`, and its wrappers to the module named here.
RENAMED_MODULES = {
    "ops/assemble_pallas.py": "ops/assemble.py",
    "ops/krylov_pallas.py": "ops/krylov.py",
    "ops/stencil_pallas.py": "ops/stencil.py",
    "ops/tridiag_pallas.py": "ops/tridiag.py",
    "models/redi_pallas.py": "models/redi_kernel.py",
    "parallel/halo_pallas.py": "parallel/halo_kernel.py",
}

#: Names the port holds in another module of the same package.
MOVED = {
    ("parallel/halo.py", "euler_propagate_halo"): "parallel/halo_kernel.py",
}

_PALLAS_ALIAS = ("a `*_pallas` alias: the port has one implementation of each kernel, and "
                 "a CUDA tensor always goes to it")
_TPU_ROUTER = "a router or guard for the TPU's kernel variants, which the port does not have"
_GSPMD = "a GSPMD mesh helper: the port's `ProcessGrid` and `grid=` replace the mesh"

#: Every name the port leaves out, and why (ROADMAP.md, "Do not port").
EXCLUDED = {
    "apply_stencil_pallas": _PALLAS_ALIAS,
    "apply_stencil_pallas_multi": _PALLAS_ALIAS,
    "assemble_T_pallas": _PALLAS_ALIAS,
    "euler_propagate_pallas": _PALLAS_ALIAS,
    "euler_propagate_pallas_multi": _PALLAS_ALIAS,
    "euler_step_pallas": _PALLAS_ALIAS,
    "euler_step_pallas_multi": _PALLAS_ALIAS,
    "redi_apply_pallas": _PALLAS_ALIAS,
    "redi_apply_pallas_multi": _PALLAS_ALIAS,
    "tridiag_solve_pallas": _PALLAS_ALIAS,
    "assemble_T_halo_pallas": _PALLAS_ALIAS,
    "apply_stencil_halo_pallas": _PALLAS_ALIAS,
    "apply_stencil_halo_pallas_multi": _PALLAS_ALIAS,
    "euler_propagate_halo_pallas": _PALLAS_ALIAS,
    "euler_propagate_halo_pallas_multi": _PALLAS_ALIAS,
    "redi_apply_halo_pallas": _PALLAS_ALIAS,
    "solve_shifted_halo_pallas": _PALLAS_ALIAS,
    "resolve_apply_impl": _TPU_ROUTER,
    "redi_supported_by_pallas": _TPU_ROUTER,
    "blocked_unstable_in_while": _TPU_ROUTER + " (a Mosaic fault in long while loops)",
    "BLOCKED_WHILE_SAFE_ITERS": _TPU_ROUTER + " (a Mosaic fault in long while loops)",
    "index_map_i32": "Mosaic's 32-bit BlockSpec index maps; CUDA kernels index themselves",
    "krylov_coeff_rows": "j-block halo rows precomputed for the blocked TPU kernel K3; the "
                         "port's K3 reads its neighbours from the whole field",
    "make_grid_mesh": _GSPMD,
    "pspec_tree": _GSPMD,
    "sharding_for": _GSPMD,
    "field_pspec": _GSPMD,
    "solve_shifted_halo_chunked": "the port's one engine runs it as "
                                  "`solve_shifted_chunked(grid=)`",
    "HBM_PEAK_GBPS": "the TPU's peak; the port's denominator is K10's measured rate",
    "load_library": "the JAX package's on-demand C++ builder with a Python fallback; the "
                    "port builds its one native core in `utils.coarsen.load_native` and "
                    "raises without g++",
    "logger": "a module's `logging.Logger`, not an API",
}

#: JAX package modules with no module in the port, and why.
EXCLUDED_MODULES = {
    "ops/pallas_util.py": "Mosaic helpers (`index_map_i32`)",
    "parallel/solve_halo_chunked.py": EXCLUDED["solve_shifted_halo_chunked"],
    "native/build.py": EXCLUDED["load_library"],
    "native/__init__.py": EXCLUDED["load_library"],
}


def _public(path: Path) -> tuple[set, list | None]:
    """The public top-level names a module defines or assigns, and its
    `__all__` (None without one)."""
    names, all_ = set(), None
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if target.id == "__all__":
                        all_ = list(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")}, all_


def _module_name(rel: str) -> str:
    parts = ["otmb_tpu_torch", *Path(rel).with_suffix("").parts]
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(str(p.relative_to(REFERENCE)) for p in REFERENCE.rglob("*.py"))


def test_the_lists_name_only_reference_names():
    """Every excluded name is a public name of the JAX package, and every
    excluded or renamed module is one of its modules."""
    reference = set().union(*(_public(REFERENCE / m)[0] for m in MODULES))
    assert set(EXCLUDED) <= reference
    assert set(EXCLUDED_MODULES) | set(RENAMED_MODULES) <= set(MODULES)
    assert all(reason for reason in EXCLUDED.values())


@pytest.mark.parametrize("rel", MODULES)
def test_module_names_are_ported(rel):
    names, all_ = _public(REFERENCE / rel)
    if rel in EXCLUDED_MODULES:
        assert names <= set(EXCLUDED), f"{rel}: {sorted(names - set(EXCLUDED))}"
        return
    module = importlib.import_module(_module_name(RENAMED_MODULES.get(rel, rel)))
    missing = []
    for name in sorted(names - set(EXCLUDED) - {"__all__"}):
        home = MOVED.get((rel, name))
        owner = importlib.import_module(_module_name(home)) if home else module
        if not hasattr(owner, name):
            missing.append(name)
    assert not missing, f"{rel}: no counterpart for {missing}"
    if all_ is not None:
        port_all = set(getattr(module, "__all__", ()))
        lacking = sorted(set(all_) - set(EXCLUDED) - port_all)
        assert not lacking, f"{rel}: __all__ lacks {lacking}"
        assert all(hasattr(module, name) for name in port_all)


@pytest.mark.parametrize("name", ["buildTadv", "buildTkH", "buildTkVML", "buildTkVdeep",
                                  "shift_values", "synthetic_device_case"])
def test_top_level_exports(name):
    import otmb_tpu_torch

    assert name in otmb_tpu_torch.__all__ and callable(getattr(otmb_tpu_torch, name))


def test_subpackage_exports():
    from otmb_tpu_torch import parallel, physics
    from otmb_tpu_torch.ops.coeffs import zeros_coeffs

    assert set(physics.__all__) == {"rho_teos10", "sigma0_teos10", "linear_eos"}
    assert "apply_stencil_halo" in parallel.__all__
    assert callable(zeros_coeffs)


def _halo_rank(grid):
    """`apply_stencil_halo` on this rank's shard, against the slice of the
    plain whole-field apply, on both topologies."""
    import otmb_tpu_torch as P
    from otmb_tpu_torch.parallel import apply_stencil_halo, shard_pytree

    rng = np.random.default_rng(0)
    out = {}
    for kind in ("tripolar", "bipolar"):
        topo = P.GridTopology(kind, 16, 8, 6)
        legs = P.StencilCoeffs(*(torch.from_numpy(rng.standard_normal(topo.shape3d))
                                 for _ in P.StencilCoeffs._fields))
        chi = torch.from_numpy(rng.standard_normal(topo.shape3d))
        sh = lambda x: shard_pytree(x, grid, topo.shape2d)
        got = apply_stencil_halo(sh(legs), sh(chi), topo, grid)
        out[kind] = float((got - sh(P.apply_stencil(legs, chi, topo))).abs().max())
    return out


def test_apply_stencil_halo_is_the_sharded_apply():
    """The JAX package's name for the one-matvec sharded apply, on a (2, 2)
    grid of gloo ranks: each shard equals the whole field's apply."""
    from otmb_tpu_torch.parallel import spawn_grid

    for rank in spawn_grid(_halo_rank, (2, 2), device="cpu", timeout_s=300):
        assert rank == {"tripolar": 0.0, "bipolar": 0.0}
