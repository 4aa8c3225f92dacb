"""The Sigma SGS model on a velocity field without a z component, in the JAX
package and in the port (float64, CPU): a watch-list reproduction.

The reacting TGV's initial velocity has no z component, so its gradient has
rank 2 and g^T g an eigenvalue that is 0 but for round-off. The Sigma
model's smallest singular value s3 is the square root of that round-off
(about 1e-8 of s1), and its eddy viscosity D = s3 (s1 - s2)(s2 - s3) / s1^2
with it: a relative change of 1e-15 in U moves mu_t by its whole size, in
both packages. The Smagorinsky model, on the same fields, moves by
round-off. This is why the stiff TGV's face fluxes on the card differ from
the CPU's by some 6e-9 of their largest value after two steps
(tools/tgv_flow_deviation.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepflame_tpu.mesh import StructuredMesh as JMesh, cyclic as jcyclic
from deepflame_tpu.turbulence.les import LESModel as JLES

import deepflame_torch.mesh as tm
from deepflame_torch.turbulence.les import LESModel as TLES

N = 8
L = 2.0 * math.pi * 1e-3


def _tgv_velocity():
    h = L / N
    c = (np.arange(N) + 0.5) * h
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    k = 2.0 * math.pi / L
    return np.stack([10.0 * np.sin(k * X) * np.cos(k * Y) * np.cos(k * Z),
                     -10.0 * np.cos(k * X) * np.sin(k * Y) * np.cos(k * Z),
                     np.zeros_like(X)])


def _mu_t_pair(package: str, kind: str):
    """mu_t at U0 and at U0 (1 + 1e-15 N(0, 1)) (seed 0), rho = 1."""
    U = _tgv_velocity()
    moved = U * (1.0 + 1e-15 * np.random.default_rng(0).normal(size=U.shape))
    out = []
    for u in (U, moved):
        if package == "jax":
            bcs = ((jcyclic(), jcyclic()),) * 3
            mesh = JMesh.box((L, L, L), (N, N, N))
            out.append(np.asarray(JLES(kind=kind).mu_t(
                1.0, jnp.asarray(u), (bcs,) * 3, mesh)))
        else:
            bcs = ((tm.cyclic(), tm.cyclic()),) * 3
            mesh = tm.StructuredMesh.box((L, L, L), (N, N, N), device="cpu")
            out.append(TLES(kind=kind).mu_t(
                1.0, torch.as_tensor(u), (bcs,) * 3, mesh).numpy())
    return out


@pytest.mark.parametrize("package", ["jax", "port"])
def test_sigma_mu_t_is_set_by_roundoff_on_a_2d_velocity(package):
    """Sigma's mu_t moves by more than a tenth of its largest value when U
    moves by 1e-15; Smagorinsky's by less than 1e-12 of its."""
    a, b = _mu_t_pair(package, "Sigma")
    assert np.abs(a).max() > 0.0
    assert np.abs(a - b).max() > 0.1 * np.abs(a).max()
    a, b = _mu_t_pair(package, "Smagorinsky")
    assert np.abs(a - b).max() < 1e-12 * np.abs(a).max()
