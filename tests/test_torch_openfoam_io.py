"""The port's OpenFOAM field reader (runtime/openfoam_io.py) against the
JAX package's, on field files this test writes: uniform and nonuniform
volScalarField and volVectorField internalFields, plain and .gz, in
blockMesh cell order (x fastest). The port returns tensors on the asked
device and type (float64 by default); values must be equal."""
import gzip

import numpy as np
import pytest
import torch

from deepflame_tpu.runtime import openfoam_io as JIO

from deepflame_torch.runtime import openfoam_io as TIO

SHAPE = (4, 3, 2)
HEAD = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    object      {name};
}}
dimensions      [0 0 0 1 0 0 0];

internalField   {body};

boundaryField
{{
    inlet {{ type fixedValue; value uniform {bval}; }}
    outlet {{ type zeroGradient; }}
}}
"""


def _write(path, name, body, vector=False, gz=False):
    text = HEAD.format(cls="volVectorField" if vector else "volScalarField",
                       name=name, body=body,
                       bval="(1 0 0)" if vector else "300")
    if gz:
        with gzip.open(str(path) + ".gz", "wt") as f:
            f.write(text)
    else:
        path.write_text(text)


def _nonuniform(vals, vector):
    if vector:
        rows = "\n".join(f"({a!r} {b!r} {c!r})" for a, b, c in vals)
        return f"nonuniform List<vector>\n{len(vals)}\n(\n{rows}\n)\n;"
    rows = "\n".join(repr(float(v)) for v in vals)
    return f"nonuniform List<scalar>\n{len(vals)}\n(\n{rows}\n)\n;"


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("case")
    t0 = root / "0"
    t0.mkdir()
    rng = np.random.default_rng(21)
    n = int(np.prod(SHAPE))
    _write(t0 / "T", "T", _nonuniform(rng.uniform(300, 2000, n), False))
    _write(t0 / "U", "U", _nonuniform(rng.normal(0, 10, (n, 3)).tolist(),
                                      True), vector=True, gz=True)
    _write(t0 / "p", "p", "uniform 101325", gz=True)
    _write(t0 / "Uu", "Uu", "uniform (1.5 -2 3e-1)", vector=True)
    _write(t0 / "Ygz", "Ygz", _nonuniform(rng.uniform(0, 1, n), False),
           gz=True)
    _write(t0 / "bad", "bad", "nonuniform List<scalar>\n5\n(\n1 2 3\n)\n;")
    return str(root)


@pytest.mark.parametrize("name", ["T", "U", "p", "Uu", "Ygz"])
def test_reads_match_jax(case, name):
    path = f"{case}/0/{name}"
    a = JIO.read_openfoam_field(path, SHAPE)
    b = TIO.read_openfoam_field(path, SHAPE, device="cpu")
    assert b.dtype == torch.float64 and b.shape == a.shape
    np.testing.assert_array_equal(b.numpy(), a)
    f = TIO.read_openfoam_field(path, SHAPE, dtype=torch.float32,
                                device="cpu")
    np.testing.assert_array_equal(f.numpy(), a.astype(np.float32))
    np.testing.assert_array_equal(
        TIO.read_openfoam_field_flat(path, device="cpu").numpy(),
        JIO.read_openfoam_field_flat(path))


def test_case_fields_and_cell_order(case):
    a = JIO.read_case_fields(case, "0", ["T", "U", "p"], SHAPE)
    b = TIO.read_case_fields(case, "0", ["T", "U", "p"], SHAPE, device="cpu")
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(b[k].numpy(), a[k])
    # blockMesh order: the file's cell 1 is (i, j, k) = (1, 0, 0)
    flat = TIO.read_openfoam_field_flat(f"{case}/0/T", device="cpu")
    assert b["T"][1, 0, 0] == flat[1] and b["T"][0, 1, 0] == flat[SHAPE[0]]
    vec = TIO.read_openfoam_field_flat(f"{case}/0/U", device="cpu")
    assert vec.shape == (24, 3) and torch.equal(b["U"][:, 1, 0, 0], vec[1])


def test_rejects_what_jax_rejects(case):
    with pytest.raises(ValueError):
        TIO.read_openfoam_field(f"{case}/0/T", (2, 2, 2), device="cpu")
    with pytest.raises(ValueError):
        TIO.read_openfoam_field_flat(f"{case}/0/bad", device="cpu")
    with pytest.raises(AssertionError):
        JIO.read_openfoam_field_flat(f"{case}/0/bad")
