"""The plain versions of the port's three CUDA kernels against the Pallas
kernels they replace (interpret mode on the CPU). The kernels themselves
are checked against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

The same numpy inputs go to ``pypic_tpu.ops.pallas_cic`` and to
``pypic_tpu_torch.ops.cuda_cic``; n = 4097 is ragged (no multiple of any
block size). Tolerances are those of tests/test_pallas.py: positions
1e-4 cells, currents and deposits 2e-5 and velocities 1e-4 of the
output's largest magnitude.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pypic_tpu.ops.pallas_cic import (
    deposit_pallas,
    picard_finalize_nodep_pallas,
    picard_iteration_pallas,
)

from pypic_tpu_torch.ops import cuda_cic

N = 4097
QM, W, DT, DX = -1.7e11, -3.2e-9, 1e-7, 0.05
GRIDS = [64, 129, 200]


def _inputs(ng, seed=7, edges=False):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, ng, N).astype(np.float32)
    v0 = (rng.normal(size=N) * 1e5).astype(np.float32)
    ps = rng.uniform(0, ng, N).astype(np.float32)
    e = (rng.normal(size=ng) * 1e3).astype(np.float32)
    if edges:
        edge = np.array([0.0, ng - 1e-4, ng], np.float32)
        p0[:3] = edge
        ps[:3] = edge
        ps[3:6] = edge
        v0[:3] = 0.0
    return e, ps, p0, v0


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _pos_close(a, b, ng):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.minimum(d, ng - d).max() < 1e-4


def _rel_close(a, b, rel):
    a = np.asarray(a, np.float64)
    np.testing.assert_allclose(np.asarray(b, np.float64), a, rtol=0,
                               atol=rel * np.abs(a).max())


@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
@pytest.mark.parametrize("emit_v", [False, True])
@pytest.mark.parametrize("ng", GRIDS)
def test_picard_iteration_plain_matches_pallas(ng, emit_v, edges):
    e, ps, p0, v0 = _inputs(ng, edges=edges)
    ref = picard_iteration_pallas(jnp.asarray(e), jnp.asarray(ps),
                                  jnp.asarray(p0), jnp.asarray(v0), ng,
                                  qm=QM, w=W, dt=DT, dx=DX, emit_v=emit_v)
    got = cuda_cic.picard_iteration(*_t(e, ps, p0, v0), ng, qm=QM, w=W,
                                    dt=DT, dx=DX, emit_v=emit_v)
    assert len(got) == len(ref)
    assert all(t.dtype == torch.float32 for t in got)
    _pos_close(ref[0], got[0].numpy(), ng)
    assert ((got[0] >= 0) & (got[0] < ng)).all()
    _rel_close(ref[-1], got[-1].numpy(), 2e-5)
    if emit_v:
        _rel_close(ref[1], got[1].numpy(), 1e-4)


@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
@pytest.mark.parametrize("ng", GRIDS)
def test_picard_finalize_nodep_plain_matches_pallas(ng, edges):
    e, ps, p0, v0 = _inputs(ng, seed=11, edges=edges)
    p1r, v1r = picard_finalize_nodep_pallas(
        jnp.asarray(e), jnp.asarray(ps), jnp.asarray(p0), jnp.asarray(v0),
        ng, qm=jnp.float32(QM), dt=DT, dx=DX)
    p1, v1 = cuda_cic.picard_finalize_nodep(*_t(e, ps, p0, v0), ng, qm=QM,
                                            dt=DT, dx=DX)
    _pos_close(p1r, p1.numpy(), ng)
    _rel_close(v1r, v1.numpy(), 1e-4)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "bounded"])
@pytest.mark.parametrize("ng", GRIDS)
def test_deposit_plain_matches_pallas(ng, periodic):
    rng = np.random.default_rng(3)
    cells = ng if periodic else ng - 1
    p = rng.uniform(0, cells, N).astype(np.float32)
    p[:2] = [0.0, cells]  # both ends of the valid range
    val = rng.normal(size=N).astype(np.float32)
    ref = deposit_pallas(jnp.asarray(p), jnp.asarray(val), ng,
                         periodic=periodic)
    got = cuda_cic.deposit(*_t(p, val), ng, periodic=periodic)
    assert got.shape == (ng,) and got.dtype == torch.float32
    _rel_close(ref, got.numpy(), 2e-5)


def test_plain_versions_count_no_launches():
    cuda_cic.reset_launch_counts()
    e, ps, p0, v0 = _t(*_inputs(64))
    cuda_cic.picard_iteration(e, ps, p0, v0, 64, qm=QM, w=W, dt=DT, dx=DX)
    cuda_cic.picard_finalize_nodep(e, ps, p0, v0, 64, qm=QM, dt=DT, dx=DX)
    cuda_cic.deposit(p0, v0, 64, periodic=True)
    assert {k: cuda_cic.LAUNCHES[k] for k in (
        "picard_iteration", "picard_finalize_nodep", "deposit")} == {
        "picard_iteration": 0, "picard_finalize_nodep": 0, "deposit": 0}
    assert set(cuda_cic.LAUNCHES.values()) == {0}


def test_kernel_scalars_are_float32_in_reference_order():
    qm = np.float32(-1.602e-19) / np.float32(9.11e-31)
    qm_dt, qm_dt2_half, dt_dx, w = cuda_cic.kernel_scalars(qm, DT, DX, W)
    f32 = np.float32
    assert qm_dt == f32(qm * f32(DT))
    assert qm_dt2_half == f32(f32(f32(f32(0.5) * qm) * f32(DT)) * f32(DT / DX))
    assert dt_dx == f32(DT / DX) and w == f32(W)


def _meta(n):
    return torch.empty(n, dtype=torch.float32, device="meta")


def test_wrappers_reject_other_devices_and_mixed_devices():
    e, ps, p0, v0 = _t(*_inputs(64))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_cic.deposit(_meta(N), _meta(N), 64, periodic=True)
    with pytest.raises(ValueError, match="different devices"):
        cuda_cic.picard_iteration(e, ps, _meta(N), v0, 64, qm=QM, w=W,
                                  dt=DT, dx=DX)


def test_wrappers_reject_bad_dtype_shape_and_layout():
    e, ps, p0, v0 = _t(*_inputs(64))
    with pytest.raises(TypeError, match="float32"):
        cuda_cic.picard_finalize_nodep(e, ps, p0, v0.double(), 64, qm=QM,
                                       dt=DT, dx=DX)
    with pytest.raises(ValueError, match="shape"):
        cuda_cic.picard_iteration(e[:10], ps, p0, v0, 64, qm=QM, w=W, dt=DT,
                                  dx=DX)
    with pytest.raises(ValueError, match="shape"):
        cuda_cic.deposit(p0, v0[:-1], 64, periodic=True)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cic.deposit(p0[::2], v0[::2].contiguous(), 64, periodic=True)


def test_wrappers_reject_grids_beyond_shared_memory():
    """The shared-memory limit is the card's: on CPU tensors the wrappers
    run their plain versions at an ng beyond it and return their answers
    (bit-equal, the same function); tests/test_torch_cuda.py holds the
    raise on the card."""
    ng = cuda_cic.SMEM_LIMIT // 8 + 1
    rng = np.random.default_rng(12)
    f = torch.from_numpy(rng.normal(size=ng).astype(np.float32) * 1e3)
    p = torch.from_numpy(rng.uniform(0, ng, 64).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=64).astype(np.float32) * 1e5)
    before = dict(cuda_cic.LAUNCHES)
    got = cuda_cic.picard_iteration(f, p, p, v, ng, qm=QM, w=W, dt=DT, dx=DX)
    ref = cuda_cic.picard_iteration_plain(f, p, p, v, ng, qm=QM, w=W, dt=DT,
                                          dx=DX)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    got = cuda_cic.picard_finalize_nodep(f, p, p, v, ng, qm=QM, dt=DT, dx=DX)
    ref = cuda_cic.picard_finalize_nodep_plain(f, p, p, v, ng, qm=QM, dt=DT,
                                               dx=DX)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    big = cuda_cic.SMEM_LIMIT // 4 + 1
    assert torch.equal(cuda_cic.deposit(p, v, big, periodic=True),
                       cuda_cic.deposit_plain(p, v, big, periodic=True))
    assert cuda_cic.LAUNCHES == before
