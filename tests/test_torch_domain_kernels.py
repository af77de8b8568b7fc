"""The plain versions of the domain engines' four CUDA kernels against the
Pallas kernels they replace (interpret mode on the CPU). The kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

The same numpy inputs go to ``pypic_tpu.ops.pallas_cic`` and to
``pypic_tpu_torch.ops.cuda_domain``: a ragged n, dead slots (w = 0),
positions past the clamp bounds on both sides, and the offset of a middle
rank. Tolerances: positions and velocities 1e-6 of the largest value,
deposits 1e-6 of the largest node (the float32 plain deposit also against
a float64 sum of the same terms), statistics 1e-6 relative, counts exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pypic_tpu.ops.pallas_cic import (
    leapfrog_gather_push_pallas,
    picard_finalize_ext_nodep_pallas,
    picard_finalize_ext_pallas,
    picard_iteration_ext_pallas,
)

from pypic_tpu_torch.ops import cuda_cic, cuda_domain

N = 12_007
QM, DT, DX = -1.7e11, 1e-7, 0.05
W = -3.2e-9
# a middle rank (d = 1 of 4) of a 128-node grid: c = 32 cells a slab,
# halo 4, hw = halo + 2, ext_n = c + 2 hw + 1, the clamp bounds and the
# slab's offset as domain_implicit computes them
NG, C, HALO = 128, 32, 4
HW = HALO + 2
EXT_N = C + 2 * HW + 1
LO, HI = float(HW - HALO), float(C + HALO + HW)
LO_SHIFT = float(np.float32(1 * C) - HW)
TOL = 1e-6


def _inputs(seed=3, spread=3.0):
    """Shifted slab positions on [LO - spread, HI + spread] (past the clamp
    on both sides, edges exact), velocities of ~0.2 cells a step, a
    smooth-ish field, and per-particle weights with 10% dead slots."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(LO - spread, HI + spread, N).astype(np.float32)
    ps = (p0 + rng.normal(size=N) * 0.3).astype(np.float32)
    v0 = (rng.normal(size=N) * 1e5).astype(np.float32)
    p0[:4] = ps[:4] = np.array([LO, HI, LO - 2.5, HI + 2.5], np.float32)
    field = (rng.normal(size=EXT_N) * 30.0).astype(np.float32)
    w = np.full(N, W, np.float32)
    w[rng.random(N) < 0.1] = 0.0
    return field, ps, p0, v0, w


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def _seam_rel(ref, got, ng):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return np.minimum(d, ng - d).max() / np.abs(np.asarray(ref)).max()


def _kw():
    return dict(qm=jnp.float32(QM), dt=DT, dx=DX, lo=LO, hi=HI)


def _tkw():
    return dict(qm=float(np.float32(QM)), dt=DT, dx=DX, lo=LO, hi=HI)


@pytest.mark.parametrize("emit_v", [False, True])
def test_iteration_ext_plain_matches_pallas(emit_v):
    field, ps, p0, v0, w = _inputs()
    ref = picard_iteration_ext_pallas(
        *(jnp.asarray(a) for a in (field, ps, p0, v0, w)), EXT_N,
        emit_v=emit_v, **_kw())
    got = cuda_domain.picard_iteration_ext(*_t(field, ps, p0, v0, w),
                                           emit_v=emit_v, **_tkw())
    assert len(got) == len(ref)
    # raw midpoints: some lie past the clamp bounds, unclamped
    ph = np.asarray(ref[0])
    assert (ph < LO).any() and (ph > HI).any()
    assert _rel(ref[0], got[0].numpy()) <= TOL
    if emit_v:
        assert _rel(ref[1], got[1].numpy()) <= TOL
    assert _rel(ref[-1], got[-1].numpy()) <= TOL
    # the float32 plain deposit against a float64 sum of its own terms
    exact = cuda_domain.picard_iteration_ext_plain(
        *_t(field, ps, p0, v0, w), acc_dtype=torch.float64, **_tkw())[-1]
    assert _rel(exact.numpy(), got[-1].numpy()) <= TOL
    assert _rel(exact.numpy(), np.asarray(ref[-1])) <= TOL


@pytest.mark.parametrize("spread", [0.0, 3.0])
def test_iteration_ext_shared_plain_matches_pallas(spread):
    """The shared-window variant: the same deposit where no deposit leaves
    the frame; the clamp count equal to the Pallas kernel's (0 without
    excursions, > 0 with iterates seeded 3 cells off)."""
    field, ps, p0, v0, w = _inputs(spread=spread)
    if spread:
        ps = (ps + np.where(np.arange(N) % 3 == 0, 2.5, 0.0)).astype(np.float32)
    else:
        ps = np.clip(p0 + 0.5 * DT / DX * v0, LO, HI).astype(np.float32)
    ref = picard_iteration_ext_pallas(
        *(jnp.asarray(a) for a in (field, ps, p0, v0, w)), EXT_N,
        share_window=True, **_kw())
    got = cuda_domain.picard_iteration_ext(*_t(field, ps, p0, v0, w),
                                           shared=True, **_tkw())
    assert _rel(ref[0], got[0].numpy()) <= TOL
    assert _rel(ref[1], got[1].numpy()) <= TOL
    assert int(ref[2]) == int(got[2])
    assert (int(got[2]) > 0) == bool(spread)
    exact = cuda_domain.picard_iteration_ext_plain(
        *_t(field, ps, p0, v0, w), shared=True, acc_dtype=torch.float64,
        **_tkw())[1]
    assert _rel(exact.numpy(), got[1].numpy()) <= TOL


def test_iteration_ext_active_flag_skips_the_pass():
    """active = 0: the outputs keep their content, jh is zero; active = 1:
    the pass writes into the given buffers (ph over ps)."""
    field, ps, p0, v0, w = _t(*_inputs())
    want = cuda_domain.picard_iteration_ext(field, ps, p0, v0, w, **_tkw())
    buf = ps.clone()
    off = torch.zeros((1,), dtype=torch.int32)
    got = cuda_domain.picard_iteration_ext(field, buf, p0, v0, w, out=(buf, None),
                                           active=off, **_tkw())
    assert got[0] is buf and torch.equal(buf, ps)
    assert not got[1].any()
    got = cuda_domain.picard_iteration_ext(field, buf, p0, v0, w, out=(buf, None),
                                           active=off + 1, **_tkw())
    assert torch.equal(buf, want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="active needs out"):
        cuda_domain.picard_iteration_ext(field, ps, p0, v0, w, active=off,
                                         **_tkw())
    with pytest.raises(ValueError, match="one int32"):
        cuda_domain.picard_iteration_ext(field, buf, p0, v0, w, out=(buf, None),
                                         active=off.long(), **_tkw())
    with pytest.raises(ValueError, match="shape"):
        cuda_domain.picard_iteration_ext(field, buf, p0, v0, w,
                                         out=(buf[:-1], None), **_tkw())


@pytest.mark.parametrize("deposit", [False, True])
def test_finalize_ext_plain_matches_pallas(deposit):
    """Stats mode at a middle rank's offset: global wrapped p1, v1, the
    three statistics (and j1 with the deposit)."""
    field, ps, p0, v0, w = _inputs()
    if deposit:
        ref = picard_finalize_ext_pallas(
            *(jnp.asarray(a) for a in (field, ps, p0, v0, w)), EXT_N,
            lo_shift=jnp.float32(LO_SHIFT), ng=NG, **_kw())
        got = cuda_domain.picard_finalize_ext(
            *_t(field, ps, p0, v0, w), lo_shift=LO_SHIFT, ng=NG, **_tkw())
    else:
        ref = picard_finalize_ext_nodep_pallas(
            *(jnp.asarray(a) for a in (field, ps, p0, v0)), EXT_N,
            w=jnp.asarray(w), lo_shift=jnp.float32(LO_SHIFT), ng=NG, **_kw())
        got = cuda_domain.picard_finalize_ext_nodep(
            *_t(field, ps, p0, v0, w), lo_shift=LO_SHIFT, ng=NG, **_tkw())
    p1 = got[0].numpy()
    assert ((p1 >= 0) & (p1 < NG)).all()
    assert _seam_rel(ref[0], p1, NG) <= TOL
    assert _rel(ref[1], got[1].numpy()) <= TOL
    st_ref = np.asarray(ref[-1], np.float64).sum(axis=1)
    st = got[-1].numpy()
    assert abs(st[0] - st_ref[0]) <= TOL * abs(st_ref[0])
    assert abs(st[1] - st_ref[1]) <= TOL * abs(st_ref[1])
    assert st[2] == st_ref[2] > 0
    alive = w != 0
    raw = cuda_domain._cn(*_t(field, ps, p0, v0), float(np.float32(QM)), DT,
                          DX, LO, HI)[1].numpy()
    assert st[2] == (alive & ((raw < LO) | (raw > HI))).sum()
    if deposit:
        assert _rel(ref[2], got[2].numpy()) <= TOL
        exact = cuda_domain.picard_finalize_ext_plain(
            *_t(field, ps, p0, v0, w), lo_shift=LO_SHIFT, ng=NG, deposit=True,
            acc_dtype=torch.float64, **_tkw())[2]
        assert _rel(exact.numpy(), got[2].numpy()) <= TOL


def test_finalize_ext_nodep_and_deposit_agree_and_raw_mode():
    """The two finalizes give the same p1, v1 and statistics; ng = 0 keeps
    the raw shifted position plus lo_shift."""
    args = _t(*_inputs())
    a = cuda_domain.picard_finalize_ext_nodep(*args, lo_shift=LO_SHIFT, ng=NG,
                                              **_tkw())
    b = cuda_domain.picard_finalize_ext(*args, lo_shift=LO_SHIFT, ng=NG,
                                        **_tkw())
    assert all(torch.equal(x, y) for x, y in zip(a, b[:2] + b[3:]))
    raw = cuda_domain.picard_finalize_ext_nodep(*args, lo_shift=0.0, ng=0,
                                                **_tkw())
    p1 = cuda_domain._cn(*args[:4], float(np.float32(QM)), DT, DX, LO, HI)[1]
    assert torch.equal(raw[0], p1)
    assert torch.equal(cuda_cic._wrap(p1 + np.float32(LO_SHIFT), NG), a[0])


@pytest.mark.parametrize("ng", [64, 200])
def test_leapfrog_gather_push_plain_matches_pallas(ng):
    rng = np.random.default_rng(5)
    p = rng.uniform(0, ng, N).astype(np.float32)
    p[:3] = [0.0, ng - 1e-4, 0.5]
    v = (rng.normal(size=N) * 1e5).astype(np.float32)
    field = (rng.normal(size=ng) * 1e3).astype(np.float32)
    ref = leapfrog_gather_push_pallas(jnp.asarray(field), jnp.asarray(p),
                                      jnp.asarray(v), qm=jnp.float32(QM),
                                      dt=DT, dx=DX)
    got = cuda_domain.leapfrog_gather_push(*_t(field, p, v),
                                           qm=float(np.float32(QM)), dt=DT,
                                           dx=DX)
    assert _seam_rel(ref[0], got[0].numpy(), ng) <= TOL
    assert _rel(ref[1], got[1].numpy()) <= TOL


def _wrap_edges(ng):
    """Positions at and just past both ends of [0, ng), where the floor
    wrap can land on ng or stay out of range; pushed by no field and no
    velocity, so the arithmetic before the wrap is exact."""
    f32 = np.float32
    p = np.array([0.0, -0.0, ng, np.nextafter(f32(ng), f32(2 * ng)),
                  np.nextafter(f32(ng), f32(0)), -1e-6, -1e-30, -ng,
                  np.nextafter(f32(-ng), f32(-2 * ng)), 2 * ng - 1e-4,
                  ng + 0.5, -0.5], f32)
    return np.zeros(ng, f32), p, np.zeros_like(p)


@pytest.mark.parametrize("ng", [64, 200])
def test_leapfrog_gather_push_plain_wraps_as_the_step_does(ng):
    """The wrapper's p1 is JAX's step's: the Pallas kernel's wrap, then
    mod ng (pypic_tpu/parallel/domain.py:637), bit for bit at the edges."""
    field, p, v = _wrap_edges(ng)
    ref = leapfrog_gather_push_pallas(jnp.asarray(field), jnp.asarray(p),
                                      jnp.asarray(v), qm=jnp.float32(QM),
                                      dt=DT, dx=DX)
    got = cuda_domain.leapfrog_gather_push(*_t(field, p, v),
                                           qm=float(np.float32(QM)), dt=DT,
                                           dx=DX)
    want = np.asarray(jnp.mod(ref[0], ng))
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert ((want >= 0) & (want <= ng)).all()


def test_domain_wrappers_count_nothing_on_the_cpu_and_check_inputs():
    field, ps, p0, v0, w = _t(*_inputs())
    cuda_cic.reset_launch_counts()
    cuda_domain.picard_iteration_ext(field, ps, p0, v0, w, **_tkw())
    cuda_domain.picard_finalize_ext(field, ps, p0, v0, w, lo_shift=0.0, ng=NG,
                                    **_tkw())
    cuda_domain.leapfrog_gather_push(field, ps, v0, qm=-1.0, dt=DT, dx=DX)
    assert not any(cuda_cic.LAUNCHES[k] for k in (
        "picard_iteration_ext", "picard_finalize_ext",
        "picard_finalize_ext_nodep", "leapfrog_gather_push"))
    with pytest.raises(ValueError, match="shape"):
        cuda_domain.picard_iteration_ext(field, ps, p0, v0, w[:-1], **_tkw())
    with pytest.raises(TypeError, match="float32"):
        cuda_domain.picard_iteration_ext(field, ps, p0, v0, w.double(), **_tkw())
    with pytest.raises(ValueError, match="ng must be"):
        cuda_domain.picard_finalize_ext(field, ps, p0, v0, w, lo_shift=0.0,
                                        ng=-1, **_tkw())
