"""Port vs reference: P2P gravity factors, PM mesh, GravitySolver.

Tolerances (relative to max |reference|): P2P factors 2e-6; TSC deposit
and gather 1e-5 (scatter-add order); Green table 1e-5; long-range fields
1e-4 (FFT summation order).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swift_subtask_dev_tpu.grid import CellGrid as RefGrid
from swift_subtask_dev_tpu.models import gravity as ref_gravity
from swift_subtask_dev_tpu.ops import p2p_gravity as ref_pg
from swift_subtask_dev_tpu.ops import pm_gravity as ref_pm
from swift_subtask_dev_tpu_torch.grid import CellGrid
from swift_subtask_dev_tpu_torch.models import gravity as port_gravity
from swift_subtask_dev_tpu_torch.ops import p2p_gravity as port_pg
from swift_subtask_dev_tpu_torch.ops import pm_gravity as port_pm

CPU = torch.device("cpu")
N_MESH = 32


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = b.cpu().numpy().astype(np.float64) if isinstance(b, torch.Tensor) \
        else np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30)


@pytest.fixture(scope="module")
def r2():
    rng = np.random.default_rng(2)
    r = np.concatenate([[0.0], rng.uniform(0, 0.2, 8191)])
    return (r * r).astype(np.float32)


@pytest.mark.parametrize("trunc", [True, False])
def test_force_pot_factors_match(r2, trunc):
    """Each side gets its own f32 copy of the inputs, and the reference
    runs jitted on the first CPU device (as its pair kernels call it), so
    no buffer, default device or dtype that an earlier test left in the
    process enters the comparison."""
    H_inv, r_s_inv = 1.0 / 0.0375, 1.0 / (1.25 / N_MESH)
    ref = jax.jit(ref_pg.force_pot_factors, static_argnums=(1, 2, 3))
    with jax.default_device(jax.devices("cpu")[0]):
        Fr, Pr = ref(jnp.array(r2, dtype=jnp.float32, copy=True), H_inv,
                     r_s_inv, trunc)
        Fr, Pr = np.asarray(Fr), np.asarray(Pr)
    assert Fr.dtype == Pr.dtype == np.float32
    Fp, Pp = port_pg.force_pot_factors(
        torch.tensor(r2, dtype=torch.float32), H_inv, r_s_inv, trunc)
    errs = {"F": _rel(Fr, Fp), "P": _rel(Pr, Pp),
            "worker": os.environ.get("PYTEST_XDIST_WORKER")}
    assert errs["F"] <= 2e-6 and errs["P"] <= 2e-6, errs


@pytest.mark.parametrize("name", ["softened_force_factor",
                                  "softened_pot_factor", "truncation_factor",
                                  "pot_truncation_factor"])
def test_standalone_factors_match(r2, name):
    arg = 0.0375 if "softened" in name else 1.0 / (1.25 / N_MESH)
    a = getattr(ref_pg, name)(jnp.asarray(r2[1:]), arg)
    b = getattr(port_pg, name)(torch.from_numpy(r2[1:]), arg)
    assert _rel(a, b) <= 2e-6


@pytest.fixture(scope="module")
def mesh_inputs():
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 1, (12, 100, 3)).astype(np.float32)
    pos[0, :4] = [[0.0, 0.0, 0.0], [0.9999, 0.5, 0.0], [0.5, 0.5, 0.5],
                  [1.0 / 64, 1.0 / 64, 1.0 / 64]]    # wrap / stencil edges
    m = rng.uniform(0.5, 1.5, (12, 100)).astype(np.float32)
    m[3] = 0.0                                       # empty slots
    return pos, m


def _pms():
    return (ref_pm.PMMeshParams(N=N_MESH, box=(1.0, 1.0, 1.0)),
            port_pm.PMMeshParams(N=N_MESH, box=(1.0, 1.0, 1.0)))


def test_deposit_and_gather_match(mesh_inputs):
    pos, m = mesh_inputs
    pm_r, pm_p = _pms()
    gr = ref_pm.deposit(pm_r, jnp.asarray(pos), jnp.asarray(m))
    gp = port_pm.deposit(pm_p, torch.from_numpy(pos), torch.from_numpy(m))
    assert _rel(gr, gp) <= 1e-5
    assert float(gp.sum()) == pytest.approx(float(m.sum()), rel=1e-5)
    rng = np.random.default_rng(8)
    fields = [rng.normal(size=(N_MESH,) * 3).astype(np.float32)
              for _ in range(4)]
    outs_r = ref_pm.gather_multi(pm_r, [jnp.asarray(f) for f in fields],
                                 jnp.asarray(pos))
    outs_p = port_pm.gather_multi(pm_p, [torch.from_numpy(f)
                                         for f in fields],
                                  torch.from_numpy(pos))
    for a, b in zip(outs_r, outs_p):
        assert _rel(a, b) <= 1e-5


def test_green_table_and_long_range_fields_match(mesh_inputs):
    pos, m = mesh_inputs
    pm_r, pm_p = _pms()
    green_r = ref_pm.green_table(pm_r, 1.0)
    green_p = port_pm.green_table(pm_p, 1.0, CPU)
    assert green_p.shape == (N_MESH, N_MESH, N_MESH // 2 + 1)
    assert _rel(green_r, green_p) <= 1e-5
    grid = ref_pm.deposit(pm_r, jnp.asarray(pos), jnp.asarray(m))
    acc_r, phi_r = ref_pm.long_range_fields(pm_r, grid, 1.0, green=green_r)
    acc_p, phi_p = port_pm.long_range_fields(
        pm_p, torch.from_numpy(np.asarray(grid).copy()), 1.0,
        green=green_p)
    assert _rel(phi_r, phi_p) <= 1e-4
    for k in range(3):
        assert _rel(acc_r[k], acc_p[k]) <= 1e-4


def test_solver_mesh_accelerations_match(mesh_inputs):
    """GravitySolver buffers and the full PM pass on a column grid."""
    rng = np.random.default_rng(12)
    grid_r = RefGrid(box=(1.0, 1.0, 1.0), cdim=(3, 3, 1), K=128)
    grid_p = CellGrid(box=(1.0, 1.0, 1.0), cdim=(3, 3, 1), K=128)
    gp_r = ref_gravity.GravityParams(G=1.0, eps=0.5 / 8, mesh_N=N_MESH)
    gp_p = port_gravity.GravityParams(G=1.0, eps=0.5 / 8, mesh_N=N_MESH)
    sol_r = ref_gravity.GravitySolver(gp_r, grid_r)
    sol_p = port_gravity.GravitySolver(gp_p, grid_p, device=CPU)
    assert dict(sol_p.named_buffers()).keys() == {"corners", "mesh_green"}
    assert np.array_equal(np.asarray(sol_r.corners), sol_p.corners.numpy())
    assert sol_p.pm.r_cut == sol_r.pm.r_cut and sol_p.pm.r_s == sol_r.pm.r_s
    mask = (rng.uniform(size=(9, 128)) > 0.3).astype(np.float32)
    s = {"mask": mask,
         "off": rng.uniform(0, 1 / 3, (9, 128, 3)).astype(np.float32),
         "m": rng.uniform(0.5, 1.5, (9, 128)).astype(np.float32) * 1e-3}
    [(ar, pr)] = sol_r.mesh_accelerations([{k: jnp.asarray(v)
                                            for k, v in s.items()}])
    [(ap, pp)] = sol_p.mesh_accelerations([{k: torch.from_numpy(v)
                                            for k, v in s.items()}])
    assert _rel(ar, ap) <= 1e-4 and _rel(pr, pp) <= 1e-4
    # the port always truncates its P2P pairs, as the reference's flat
    # solver advertises for its fused pass
    fs = sol_p.gas_short_range_fn().fuse_spec
    fs_r = dict(sol_r.gas_short_range_fn().fuse_spec)
    assert fs_r.pop("periodic_truncation") is True
    assert fs == fs_r
