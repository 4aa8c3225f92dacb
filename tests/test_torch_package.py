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


# Every script of examples/ with the port function that runs it, or
# ("absent", a file it needs that the repository lacks, named in ROADMAP
# section A's "Not queued" list). The H2_Li examples run on the test
# mechanism, as every port path does; aachen_bomb_3d sprays water where the
# example sprays n-heptane (C7_oneStep is absent).
EXAMPLES = {
    "aachen_bomb_2d.py": ("absent", "C7_oneStep.yaml"),
    "aachen_bomb_3d.py": ("port", "cases.aachen_bomb_3d"),
    "detonation_1d.py": ("port", "cases.detonation_1d"),
    "detonation_1d_amr.py": ("port", "cases.detonation_1d_amr"),
    "detonation_1d_c7mist.py": ("absent", "C7_oneStep.yaml"),
    "detonation_1d_watermist.py": ("port", "cases.watermist_detonation_1d"),
    "detonation_2d.py": ("port", "cases.detonation_2d_h2_amr"),
    "detonation_2d_c2h4_mist.py": ("absent", "C2H4_r10.yaml"),
    "flame_1d.py": ("port", "cases.flame_1d"),
    "flame_1d_anchored.py": ("port", "cases.flame_1d_anchored"),
    "flame_dnn_closed_loop.py": ("port", "cases.dnn_closed_loop_flame"),
    "hit_flame_2d.py": ("absent", "drm19.yaml"),
    "jet_flame_2d.py": ("port", "cases.jet_flame_2d"),
    "reacting_tgv_2d.py": ("port", "cases.reacting_tgv_2d"),
    "reacting_tgv_2d_reference_ics.py": ("absent", "ES80_H2-7-16.yaml"),
    "reacting_tgv_3d_les.py": ("port", "cases.reacting_tgv_3d_les"),
    "reactive_shock_tube_1d.py": ("absent", "H2_AR.yaml"),
    "reactor_0d.py": ("port", "chemistry.reactor.ignite"),
    "sandia_d_fgm_2d.py": ("port", "cases.sandia_d_fgm_2d"),
    "sandia_d_wedge_fgm.py": ("absent", "blockMeshDict"),
    "shock_watermist_1d.py": ("port", "cases.shock_watermist_1d"),
    "single_droplet_motion.py": ("port", "cases.droplet_relaxation"),
    "supercritical_tgv_2d.py": ("absent", "2s_CH4_BFER_N2.yaml"),
    "sydney_spray_burner.py": ("absent", "ethanol66.yaml"),
    "temporal_jet_2d.py": ("absent", "drm19.yaml"),
    "train_dfodenet.py": ("port", "chemistry.dnn_train.train_dfodenet"),
    "triple_flame_2d.py": ("absent", "ES80_H2-7-16.yaml"),
}


def _repo_files() -> set:
    """Base names of every file in the repository's tree (less .git and
    what builds and runs write)."""
    skip = {".git", "build", "chiprun_out", "_proof", "__pycache__"}
    names = set()
    for d, dirs, files in os.walk(ROOT):
        dirs[:] = [x for x in dirs if x not in skip]
        names.update(files)
    return names


def test_every_example_is_run_by_the_port_or_needs_an_absent_file():
    """EXAMPLES maps every examples/*.py: to a port function that exists
    and is callable, or to a file that the example's source names, that no
    file of the repository is, and that ROADMAP.md names among the files
    the repository lacks."""
    import importlib
    scripts = {f for f in os.listdir(os.path.join(ROOT, "examples"))
               if f.endswith(".py")}
    assert scripts == set(EXAMPLES), sorted(scripts ^ set(EXAMPLES))
    roadmap = open(os.path.join(ROOT, "ROADMAP.md")).read()
    present = _repo_files()
    for script, (kind, what) in EXAMPLES.items():
        if kind == "port":
            mod, name = what.rsplit(".", 1)
            fn = getattr(importlib.import_module("deepflame_torch." + mod),
                         name)
            assert callable(fn), script
        else:
            assert kind == "absent", script
            src = open(os.path.join(ROOT, "examples", script)).read()
            assert what in src, (script, what)
            assert what not in present, (script, what)
            assert what in roadmap, (script, what)
    assert sum(k == "port" for k, _ in EXAMPLES.values()) >= 16


def _argparse_defaults(script: str) -> dict:
    """{dest: default} of every ap.add_argument(...) in an example, read
    with ast (no import): the default= literal, False for store_true, else
    None; and "forced_dtype" where main() calls configure(..., "<dtype>")
    with a literal."""
    import ast
    tree = ast.parse(open(os.path.join(ROOT, "examples", script)).read())
    out = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if getattr(node.func, "attr", None) == "add_argument":
            dest = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                out[dest] = ast.literal_eval(kw["default"])
            elif "action" in kw:
                out[dest] = ast.literal_eval(kw["action"]) == "store_false"
            else:
                out[dest] = None
        elif getattr(node.func, "id", None) == "configure" \
                and isinstance(node.args[1], ast.Constant):
            out["forced_dtype"] = node.args[1].value
    return out


# per example: its builder and {argparse dest: builder parameter}; the
# --platform option is the builder's `device` (None: the card)
DEFAULTS = {
    "flame_1d.py": ("flame_1d", {"cells": "n", "length": "length",
                                 "T_u": "T_u", "steps": "steps", "dt": "dt",
                                 "dtype": "dtype"}),
    "reacting_tgv_2d.py": ("reacting_tgv_2d", {
        "cells": "n", "t_end": "t_end", "dt": "dt", "dtype": "dtype",
        "out": "out_dir"}),
    "jet_flame_2d.py": ("jet_flame_2d", {"model": "model", "cells": "n",
                                         "steps": "steps", "dt": "dt",
                                         "forced_dtype": "dtype"}),
    "detonation_1d.py": ("detonation_1d", {
        "cells": "n", "length": "length", "t_end": "t_end",
        "dtype": "dtype", "flux": "flux", "cfl": "cfl",
        "driver_frac": "driver_frac", "driver_pratio": "driver_pratio",
        "driver_T": "driver_T"}),
    "shock_watermist_1d.py": ("shock_watermist_1d", {
        "cells": "n", "t_end": "t_end", "dry": "dry", "dtype": "dtype",
        "cfl": "cfl"}),
    "single_droplet_motion.py": ("droplet_relaxation", {"dtype": "dtype"}),
}


@pytest.mark.parametrize("script", sorted(DEFAULTS))
def test_example_builders_take_their_examples_defaults(script):
    """Each new builder's defaults are its example's argparse defaults
    (read from the script's source; "f64"/"f32" as torch's float64 and
    float32), every option of the example has its parameter, and the
    example's --platform is the builder's device=None (the card). The
    droplet's gas, droplet and runs are the script's constants."""
    import ast
    import inspect
    from deepflame_torch import cases
    name, params = DEFAULTS[script]
    ex = _argparse_defaults(script)
    sig = inspect.signature(getattr(cases, name)).parameters
    assert sig["device"].default is None and "platform" in ex
    assert set(ex) - {"platform"} == set(params), script
    as_torch = {"f64": torch.float64, "f32": torch.float32}
    for dest, param in params.items():
        want = ex[dest]
        want = as_torch.get(want, want) if "dtype" in dest else want
        assert sig[param].default == want, (script, dest, param)
    if script == "single_droplet_motion.py":
        tree = ast.parse(open(os.path.join(ROOT, "examples", script)).read())
        consts = {t.id: ast.literal_eval(n.value) for n in tree.body
                  if isinstance(n, ast.Assign) for t in n.targets
                  if isinstance(t, ast.Name) and t.id in cases.DROPLET_GAS
                  and isinstance(n.value, ast.Constant)}
        assert consts == cases.DROPLET_GAS
        loops = [ast.literal_eval(n.iter) for n in ast.walk(tree)
                 if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple)]
        assert loops == [cases.DROPLET_RUNS]
        assert inspect.signature(cases.single_droplet_motion).parameters[
            "dtype"].default == torch.float64
