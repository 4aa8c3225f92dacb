"""Rules of the PyTorch port as a package: it imports neither JAX nor the JAX
package, its entry points need the CUDA card unless the CPU is asked for, and
its CPU path never counts a kernel launch."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MECH = os.path.join(ROOT, "tests", "data", "h2_air_9sp.json")
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|deepflame_tpu)\b", re.M)


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "deepflame_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_sources_import_no_jax():
    files = _port_files()
    assert len(files) > 15
    assert any(os.sep + "runtime" + os.sep in f for f in files)
    assert any(f.endswith("low_mach_fl.py") for f in files)
    bad = [f for f in files if _IMPORT.search(open(f).read())]
    assert not bad, bad
    # the native sources the port builds are its own copies, naming neither
    csrc = os.path.join(ROOT, "deepflame_torch", "csrc")
    cpp = [os.path.join(csrc, n) for n in os.listdir(csrc)
           if n.endswith(".cpp")]
    assert len(cpp) == 2
    assert not [f for f in cpp
                if re.search(r"jax|deepflame_tpu", open(f).read())]


def test_port_modules_load_no_jax():
    """Importing every module of the port (and the smoke script) leaves JAX
    and the JAX package unloaded."""
    code = (
        "import sys, runpy\n"
        "import deepflame_torch.cases, deepflame_torch.convert\n"
        "import deepflame_torch.solvers.low_mach, deepflame_torch.ops.kernels\n"
        "import deepflame_torch.chemistry.dnn, deepflame_torch.combustion\n"
        "import deepflame_torch.chemistry.dnn_train\n"
        "import deepflame_torch.runtime.factory, deepflame_torch.runtime.driver\n"
        "import deepflame_torch.mesh.geometry, deepflame_torch.mesh.facelist\n"
        "import deepflame_torch.mesh.blockmesh, deepflame_torch.mesh.polymesh\n"
        "import deepflame_torch.ops.fv_facelist, deepflame_torch.ops.multigrid\n"
        "import deepflame_torch.ops.compensated\n"
        "import deepflame_torch.solvers.low_mach_fl\n"
        "import deepflame_torch.parallel.distributed\n"
        "import deepflame_torch.parallel.distributed_fl\n"
        "import deepflame_torch.chemistry.real_gas, deepflame_torch.ops.lts\n"
        "import deepflame_torch.runtime.openfoam_io\n"
        "import deepflame_torch.runtime.platform\n"
        "import deepflame_torch.runtime.derived\n"
        "import deepflame_torch.runtime.function_objects\n"
        "import deepflame_torch.utils.flame_speed\n"
        "import deepflame_torch.combustion.edc, deepflame_torch.combustion.pasr\n"
        "import deepflame_torch.solvers.high_speed, deepflame_torch.solvers.fgm\n"
        "import deepflame_torch.ops.riemann, deepflame_torch.utils.cj\n"
        "import deepflame_torch.combustion.fgm, deepflame_torch.native\n"
        "import deepflame_torch.solvers.spray, deepflame_torch.lagrangian\n"
        "import deepflame_torch.turbulence.ras\n"
        "import deepflame_torch.mesh.amr, deepflame_torch.mesh.patch_amr\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('deepflame_tpu')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_need_a_card_or_the_cpu():
    """Without a CUDA card, entry points raise unless device='cpu' is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from deepflame_torch.chemistry import load_mechanism, make_thermo
    from deepflame_torch.convert import mechanism_from_numpy
    from deepflame_torch.mesh import StructuredMesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_mechanism(MECH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StructuredMesh.box([1.0, 1.0, 1.0], [4, 4, 4])
    mech = load_mechanism(MECH, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mechanism_from_numpy({k: getattr(mech, k) for k in
                              ("name", "species_names", "element_names")
                              + tuple(mech.__dataclass_fields__)
                              if k != "device"})
    # tables follow the device their mechanism was loaded for
    assert make_thermo(mech).W.device.type == "cpu"


def test_cpu_step_counts_no_launch():
    """A step on the CPU runs the plain versions: no kernel launch counted."""
    from deepflame_torch.cases import reacting_tgv_3d_les
    from deepflame_torch.ops import kernels as K
    K.reset_launches()
    solver, state = reacting_tgv_3d_les(MECH, n=4, dtype=torch.float64,
                                        device="cpu")
    state, diag = solver.step(state, 2.5e-7)
    assert all(v == 0 for v in K.launches.values())
    assert torch.isfinite(state.T).all()
    assert np.isfinite(float(diag["continuity_err"]))


def test_cpu_facelist_step_counts_no_launch():
    """The face-list jet on the CPU takes ell_matvec's plain version: no
    kernel launch counted; its mesh entry points need a card or the CPU."""
    from deepflame_torch.cases import jet_blockmesh_dict, jet_flame_3d_les_fl
    from deepflame_torch.mesh import build_blockmesh, parse_blockmesh_dict
    from deepflame_torch.ops import kernels as K
    gm = build_blockmesh(parse_blockmesh_dict(jet_blockmesh_dict(2)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gm.with_bcs({n: None for n in gm.patch_names})
    solver, state = jet_flame_3d_les_fl(MECH, n=2, dtype=torch.float64,
                                        device="cpu")
    K.reset_launches()
    state, diag = solver.step(state, 5e-7)
    assert all(v == 0 for v in K.launches.values())
    assert torch.isfinite(state.T).all() and int(diag["iters_p"]) > 0


def test_cpu_dnn_step_counts_no_launch():
    """The DNN step on the CPU runs mlp_fused's plain version: no kernel
    launch counted, and the fused route was taken."""
    from deepflame_torch.cases import reacting_tgv_3d_les_dnn
    from deepflame_torch.ops import kernels as K
    solver, state = reacting_tgv_3d_les_dnn(MECH, n=4, dtype=torch.float32,
                                            hidden=(32, 16, 16), device="cpu")
    K.reset_launches()
    state, _ = solver.step(state, 2.5e-7)
    assert all(v == 0 for v in K.launches.values())
    assert solver.combustion.net.fused
    assert torch.isfinite(state.T).all()


def test_cpu_structured_jet_counts_no_launch():
    """The structured jet with multigrid pressure preconditioning on the CPU
    takes the plain versions of the stencil and Helmholtz kernels on every
    level: no kernel launch counted; without a card its case function
    needs device='cpu'."""
    import dataclasses
    from deepflame_torch.cases import jet_flame_3d_les
    from deepflame_torch.ops import kernels as K
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            jet_flame_3d_les(MECH, n=2)
    solver, state = jet_flame_3d_les(MECH, n=4, dtype=torch.float64,
                                     device="cpu")
    solver = dataclasses.replace(solver, config=dataclasses.replace(
        solver.config, p_precond="mg"))
    K.reset_launches()
    state, diag = solver.step(state, 5e-7)
    assert all(v == 0 for v in K.launches.values())
    assert torch.isfinite(state.T).all() and int(diag["iters_p"]) > 0


def test_cpu_high_speed_and_fgm_steps_count_no_launch():
    """The detonation's chemistry drain (gj_inverse) and the FGM jet's
    scalar and pressure solves (stencil, Helmholtz) on the CPU take the
    plain versions: no kernel launch counted; without a card their case
    functions need device='cpu'."""
    from deepflame_torch.cases import (detonation_2d_h2, detonation_dt,
                                       sandia_d_fgm_2d)
    from deepflame_torch.ops import kernels as K
    table = os.path.join(ROOT, "data", "flare_H2_Li_4D.tbl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            detonation_2d_h2(MECH, nx=8, ny=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sandia_d_fgm_2d(table, nx=8, ny=4)
    solver, state = detonation_2d_h2(MECH, nx=12, ny=2, dtype=torch.float64,
                                     device="cpu", igniters=((0.0, 0.05),))
    fgm, fstate = sandia_d_fgm_2d(table, nx=8, ny=8, dtype=torch.float64,
                                  device="cpu")
    K.reset_launches()
    state, diag = solver.step(state, detonation_dt(solver))
    fstate, fdiag = fgm.step(fstate, 1e-5)
    assert all(v == 0 for v in K.launches.values())
    assert diag["chem_lanes"] > 0 and int(diag["chem_trips"]) > 0
    assert int(fdiag["iters_Z"]) > 0 and int(fdiag["iters_p"]) > 0
    assert torch.isfinite(state.T).all() and torch.isfinite(fstate.T).all()


def test_high_speed_batch_axis_leaves_the_unbatched_step_unchanged():
    """The density-based step's batch axis (FrontPatchAMR2D's rows): a
    state of the reacting channel stepped with a batch of one (rho (1, nx,
    ny, nz), rhoU (3, 1, ...), rhoY (ns, 1, ...)) gives the unbatched
    step's numbers bit for bit, by step and by step_with_flux_x with its
    fluxes; the stacked ghost coefficients gain the unit batch axis."""
    from deepflame_torch.cases import detonation_2d_h2, detonation_dt
    from deepflame_torch.solvers.high_speed import HighSpeedState
    solver, s = detonation_2d_h2(MECH, nx=24, ny=4, dtype=torch.float64,
                                 device="cpu", igniters=((0.0, 0.05),))
    dt = detonation_dt(solver)
    s, _ = solver.step(s, dt)
    lead = {"rhoU": 1, "rhoY": 1}

    def batch(x):
        return HighSpeedState(*(v.unsqueeze(lead.get(k, 0))
                                for k, v in x._asdict().items()))

    def unbatch(x):
        return {k: v.squeeze(lead.get(k, 0)) for k, v in x.items()}

    one, d1 = solver.step(s, dt)
    many, dn = solver.step(batch(s), dt)
    assert d1["chem_lanes"] == dn["chem_lanes"] > 0
    for k, v in unbatch(many._asdict()).items():
        assert torch.equal(v, getattr(one, k)), k
    one, _, f1 = solver.step_with_flux_x(s, dt)
    many, _, fn = solver.step_with_flux_x(batch(s), dt)
    for k, v in unbatch(many._asdict()).items():
        assert torch.equal(v, getattr(one, k)), k
    for k, v in unbatch(fn).items():
        assert torch.equal(v, f1[k]), k
    a_lo = solver.bcs_prim_batched[0][0].value[0]
    assert solver.bcs_prim[0][0].kind == "affine"
    assert tuple(a_lo.shape) == (5 + 9, 1, 1, 1, 1)


# Names of JAX modules' __all__ the port does not export yet, each with the
# ROADMAP section A queue that ports it. Nothing else may be missing.
QUEUED = {}
# JAX modules with no counterpart in the port yet, each with its ROADMAP
# section A queue; nothing else of the JAX package may be missing
QUEUED_MODULES = {}
# JAX modules whose port counterpart has another name: the TPU kernels'
# module and the port's hand-written CUDA kernels' module
COUNTERPART = {"ops.pallas_kernels": "ops.kernels"}


def _port_modules(package: str = "deepflame_torch"):
    """Dotted names (relative to the package) of every module and package
    of the port (or of the JAX package)."""
    root = os.path.join(ROOT, package)
    out = []
    for d, _, names in os.walk(root):
        for n in names:
            if not n.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, n), root)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out.append(".".join(parts))
    return sorted(out)


def test_port_exports_what_jax_exports():
    """Every port module and package whose JAX counterpart has an __all__
    exports each of its names, less those ROADMAP section A still queues
    (QUEUED, with their tags); every queued name is really missing. And
    every module of the JAX package has its port counterpart (of the same
    dotted name, or COUNTERPART's), less those QUEUED_MODULES lists; every
    listed module is really missing."""
    import importlib
    checked, missing = 0, {}
    for rel in _port_modules():
        jname = "deepflame_tpu" + ("." + rel if rel else "")
        try:
            jmod = importlib.import_module(jname)
        except ModuleNotFoundError:
            continue          # a module of the port's own (device, convert)
        jall = getattr(jmod, "__all__", None)
        if jall is None:
            continue
        tmod = importlib.import_module("deepflame_torch"
                                       + ("." + rel if rel else ""))
        gone = set(jall) - set(getattr(tmod, "__all__", ()))
        for n in gone | set(getattr(tmod, "__all__", ())):
            if n in getattr(tmod, "__all__", ()):
                assert hasattr(tmod, n), (rel, n)
        queued = QUEUED.get(rel, {})
        if gone - set(queued):
            missing[rel] = sorted(gone - set(queued))
        assert set(queued) <= gone, (rel, sorted(set(queued) - gone))
        checked += 1
    assert not missing, missing
    assert checked >= 40
    port = set(_port_modules())
    jax_mods = _port_modules("deepflame_tpu")
    absent = {rel for rel in jax_mods if COUNTERPART.get(rel, rel) not in port}
    assert absent == set(QUEUED_MODULES), (sorted(absent),
                                           sorted(QUEUED_MODULES))
    assert len(jax_mods) >= 70
    roadmap = open(os.path.join(ROOT, "ROADMAP.md")).read()
    tags = [t for q in QUEUED.values() for t in q.values()]
    for tag in tags + list(QUEUED_MODULES.values()):
        assert f"[{tag.split('.')[0]}]" in roadmap, tag


# Public module-level functions of JAX modules the port does not have, each
# with its reason. Nothing else may be missing.
NO_COUNTERPART = {
    # XLA's persistent compile cache: the port compiles nothing through XLA
    ("", "enable_compile_cache"),
    # TPU VMEM fit checks of the Pallas kernels' tiling; the Hopper kernels
    # take any size up to their own limits (ops.kernels.gj_limits)
    ("ops.pallas_kernels", "fits_vmem"),
    ("ops.pallas_kernels", "fits_vmem_tiled"),
    ("ops.pallas_kernels", "fits_stencil_tiled"),
}
# The Pallas kernels' functions and the port's kernel wrappers that replace
# them (ops.kernels)
KERNEL_COUNTERPART = {"gj_inverse_lanes": "gj_inverse",
                      "helmholtz_apply": "helmholtz7_apply",
                      "helmholtz_apply_tiled": "helmholtz7_apply",
                      "mlp_fused_lanes": "mlp_fused",
                      "stencil_apply_tiled": "stencil7_apply",
                      "ell_matvec": "ell_matvec"}


def _public_members(path: str) -> tuple[set, dict]:
    """(public functions defined at module level, {public class: its public
    methods defined in its body}) of a source file, read with ast."""
    import ast
    tree = ast.parse(open(path).read())
    fn = (ast.FunctionDef, ast.AsyncFunctionDef)
    funcs = {n.name for n in tree.body
             if isinstance(n, fn) and not n.name.startswith("_")}
    classes = {n.name: {m.name for m in n.body
                        if isinstance(m, fn) and not m.name.startswith("_")}
               for n in tree.body if isinstance(n, ast.ClassDef)
               and not n.name.startswith("_")}
    return funcs, classes


def _source(package: str, rel: str) -> str:
    base = os.path.join(ROOT, package, *rel.split(".")) if rel \
        else os.path.join(ROOT, package)
    return (os.path.join(base, "__init__.py") if os.path.isdir(base)
            else base + ".py")


def test_port_has_every_public_function_and_method_of_jax():
    """Every public module-level function and every public method of a
    public class of each JAX module is defined in the port's counterpart
    module (of the same dotted name, or COUNTERPART's; the Pallas kernels
    by KERNEL_COUNTERPART's names), less NO_COUNTERPART's, each of which is
    really missing. __all__ alone (test_port_exports_what_jax_exports)
    cannot see a method or an unexported function."""
    missing, checked = set(), 0
    for rel in _port_modules("deepflame_tpu"):
        jf, jc = _public_members(_source("deepflame_tpu", rel))
        tf, tcls = _public_members(_source("deepflame_torch",
                                           COUNTERPART.get(rel, rel)))
        if rel == "ops.pallas_kernels":
            jf = {KERNEL_COUNTERPART.get(f, f) for f in jf}
        missing |= {(rel, f) for f in jf - tf}
        for cls, methods in jc.items():
            if cls not in tcls:
                missing.add((rel, cls))
                continue
            missing |= {(rel, f"{cls}.{m}") for m in methods - tcls[cls]}
            checked += len(methods)
        checked += len(jf)
    assert missing == NO_COUNTERPART, sorted(missing ^ NO_COUNTERPART)
    assert checked >= 300
