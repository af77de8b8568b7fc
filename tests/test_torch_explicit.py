"""The explicit leapfrog slice of pypic_tpu_torch against pypic_tpu.

The same numpy inputs go through the JAX function and its port. Kernels:
the port's plain versions (the tensors lie on the CPU) against the Pallas
kernels in interpret mode, at the sizes and tolerances of
tests/test_pallas.py. Engine: the port's make_step against
``pypic_tpu.engines.explicit`` on its composed backend (no Pallas on the
CPU), at the tolerances of tests/test_engines.py:273-279. Tolerances are
relative to each output's largest magnitude unless they say cells; the
comments give the gaps measured on the CPU.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu import presets as jpresets
from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.engines import explicit as jexplicit
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.ops import pallas_cic
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch import devices, interop, presets
from pypic_tpu_torch.engines import explicit, implicit
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, fd, poisson
from pypic_tpu_torch.push import cn_push, leapfrog_push
from pypic_tpu_torch.runner import run
from pypic_tpu_torch.tools import two_stream

N = 4099
QM, W, DT, DX = -1.7e11, 3.2e-9, 1e-7, 0.05
STEPS = 50


def _close(ref, got, rel):
    ref = np.asarray(ref, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


def _pos_gap(ref, got, ng):
    """Largest position gap in cells, a pair across the periodic seam
    counted the short way round."""
    d = np.abs(np.asarray(ref, np.float64) - np.asarray(got, np.float64))
    return np.minimum(d, ng - d).max()


def _particles(ng, seed=17, edges=True):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, ng, N).astype(np.float32)
    v = (rng.normal(size=N) * 1e5).astype(np.float32)
    e = (rng.normal(size=ng) * 1e3).astype(np.float32)
    if edges:
        p[:3] = [0.0, ng - 1e-4, ng]
        v[:3] = 0.0
    return e, p, v


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ng,periodic", [(200, True), (51, False)])
def test_gather_plain_matches_pallas(ng, periodic):
    rng = np.random.default_rng(5)
    cells = ng if periodic else ng - 1
    p = rng.uniform(0, cells, 5000).astype(np.float32)
    p[:2] = [0.0, cells]
    f = rng.normal(size=ng).astype(np.float32)
    ref = pallas_cic.gather_pallas(jnp.asarray(f), jnp.asarray(p),
                                   periodic=periodic)
    got = cuda_cic.gather(*_t(f, p), periodic=periodic)
    assert got.shape == (5000,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("ng", [64, 129, 200])
def test_leapfrog_deposit_plain_matches_pallas(ng):
    e, p, v = _particles(ng)
    p1r, v1r, rhor = pallas_cic.leapfrog_gather_push_deposit_pallas(
        jnp.asarray(e), jnp.asarray(p), jnp.asarray(v), qm=jnp.float32(QM),
        w=jnp.float32(W), dt=DT, dx=DX)
    p1, v1, rho = cuda_cic.leapfrog_gather_push_deposit(*_t(e, p, v), qm=QM,
                                                        w=W, dt=DT, dx=DX)
    assert _pos_gap(p1r, p1, ng) < 1e-4
    _close(v1r, v1, 1e-4)
    _close(rhor, rho, 2e-5)


@pytest.mark.parametrize("ng", [64, 200])
def test_explicit_cycle_plain_matches_pallas(ng):
    """The one-kernel cycle, its epilogue solve included: the port solves
    rho -> E in float64 in the direct form, the Pallas kernel with its
    float32 operator (e1 measured 5e-6 apart at ng = 200)."""
    e, p, v = _particles(ng, seed=19)
    fold, me = pallas_cic.explicit_cycle_matrices(ng, DX)
    ref = pallas_cic.explicit_cycle_pallas(
        jnp.asarray(e), jnp.asarray(p), jnp.asarray(v), ng, qm=jnp.float32(QM),
        w=jnp.float32(W), dt=DT, dx=DX, fold_mat=fold, me_mat=me)
    got = cuda_cic.explicit_cycle(*_t(e, p, v), ng, qm=QM, w=W, dt=DT, dx=DX)
    assert [tuple(t.shape) for t in got] == [(N,), (N,), (ng,), (ng,)]
    assert _pos_gap(ref[0], got[0], ng) < 1e-4
    _close(ref[1], got[1], 1e-4)
    _close(ref[2], got[2], 2e-5)
    _close(ref[3], got[3], 5e-4)


@pytest.mark.parametrize("ng", [64, 200, 1024, 1536])
def test_direct_field_solve_matches_fft_solve_in_float64(ng):
    """The explicit kernels' O(ng) solve is the FFT solve + centered
    gradient of ops/poisson.py and ops/fd.py, as a prefix sum (measured
    <= 8e-13 apart in float64)."""
    rho = torch.from_numpy(np.random.default_rng(ng).normal(size=ng) * 1e-9
                           - 1.6e-9)
    ref = -fd.grad_periodic(poisson.solve_periodic_neutralized(rho, DX), DX)
    got = cuda_cic.field_from_rho_plain(rho, DX)
    assert got.dtype == torch.float64
    _close(ref, got, 1e-10)
    assert cuda_cic.field_from_rho_plain(rho.float(), DX).dtype == torch.float32


def _two_stream_load(n=20_000, ng=64, seed=2):
    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    x, v, params = jinit.initialize_periodic(
        "two-stream", n, density, 1, 0.05,
        JGridSpec(ng, 15.0 * debye, "periodic"), te, te, seed=seed)
    return ng, 15.0 * debye, x, v, params


def _configs(ng, length, params, **kw):
    jcfg = jexplicit.ExplicitConfig(JGridSpec(ng, length, "periodic"),
                                    0.1 / params.wp, params.p2c, **kw)
    tcfg = explicit.ExplicitConfig(GridSpec(ng, length, "periodic"),
                                   0.1 / params.wp, params.p2c)
    return jcfg, tcfg


@pytest.mark.slow  # ~3.5 s on the CPU: the Pallas resident kernel interpreted
def test_explicit_resident_plain_matches_pallas():
    """run_resident on both sides: the Pallas resident kernel and the
    port's plain resident version, 5 steps in chunks of 3 and 2."""
    ng, length, x, v, params = _two_stream_load(n=4097, ng=200)
    jcfg, tcfg = _configs(ng, length, params, backend="fused")
    jfin, jm = jexplicit.run_resident(
        jcfg, jexplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg), 5,
        steps_per_call=3)
    tfin, tm = explicit.run_resident(
        tcfg, explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg,
                                  device="cpu"), 5, steps_per_call=3)
    assert _pos_gap(jfin.p, tfin.p, ng) < 1e-4  # measured 0
    _close(jfin.v, tfin.v, 1e-4)
    _close(jfin.rho, tfin.rho, 2e-5)
    _close(jfin.e, tfin.e, 5e-4)
    assert int(tfin.step) == 5
    np.testing.assert_allclose(tm.field_energy.numpy(),
                               np.asarray(jm.field_energy), rtol=1e-4)
    np.testing.assert_allclose(tm.kinetic_energy.numpy(),
                               np.asarray(jm.kinetic_energy), rtol=1e-5)
    _close(jm.current_bias, tm.current_bias, 1e-4)


def test_resident_plain_equals_loop_of_cycle():
    """test_pallas.py:392-428 for the port: run_resident reproduces the
    per-step one-kernel path bit for bit, remainder chunk included, and
    its metric rows within 1e-6 / 1e-5 (measured equal)."""
    ng, length, x, v, params = _two_stream_load(n=4097, ng=200)
    _, cfg = _configs(ng, length, params)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    fin1, m1 = run(explicit.make_step(cfg), st, 37)
    fin2, m2 = explicit.run_resident(cfg, st, 37, steps_per_call=16)
    for k in ("p", "v", "rho", "e"):
        assert torch.equal(getattr(fin1, k), getattr(fin2, k)), k
    assert int(fin2.step) == 37
    np.testing.assert_allclose(m2.field_energy.numpy(),
                               m1.field_energy.numpy(), rtol=1e-6)
    np.testing.assert_allclose(m2.kinetic_energy.numpy(),
                               m1.kinetic_energy.numpy(), rtol=1e-5)
    assert m2.current_bias.shape == (37,)


def test_plain_versions_count_no_launches():
    cuda_cic.reset_launch_counts()
    e, p, v = _t(*_particles(64))
    cuda_cic.gather(e, p, periodic=True)
    cuda_cic.leapfrog_gather_push_deposit(e, p, v, qm=QM, w=W, dt=DT, dx=DX)
    cuda_cic.explicit_cycle(e, p, v, 64, qm=QM, w=W, dt=DT, dx=DX)
    cuda_cic.explicit_cycle_resident(e, p, v, 64, 2, qm=QM, w=W, ke_c=1.0,
                                     jb_c=1.0, dt=DT, dx=DX, fe_c=1.0)
    assert set(cuda_cic.LAUNCHES.values()) == {0}


def test_leapfrog_scalars_are_float32_in_reference_order():
    f32 = np.float32
    qm = f32(-1.602e-19) / f32(9.11e-31)
    qmh, dt_dx, w = cuda_cic.leapfrog_scalars(qm, DT, DX, W)
    assert qmh == f32(f32(f32(0.5) * qm) * f32(DT))
    assert dt_dx == f32(DT / DX) and w == f32(W)


def test_wrappers_check_their_inputs():
    e, p, v = _t(*_particles(64))
    with pytest.raises(ValueError, match="shape"):
        cuda_cic.explicit_cycle(e, p, v[:-1], 64, qm=QM, w=W, dt=DT, dx=DX)
    with pytest.raises(ValueError, match="shape"):
        cuda_cic.explicit_cycle(e, p, v, 65, qm=QM, w=W, dt=DT, dx=DX)
    with pytest.raises(TypeError, match="float32"):
        cuda_cic.gather(e.double(), p, periodic=True)
    with pytest.raises(ValueError, match="n <= 32768"):
        big = torch.zeros(cuda_cic.RESIDENT_MAX_N + 1)
        cuda_cic.explicit_cycle_resident(e, big, big, 64, 1, qm=QM, w=W,
                                         ke_c=1.0, jb_c=1.0, dt=DT, dx=DX,
                                         fe_c=1.0)
    # the shared-memory limit is the card's (tests/test_torch_cuda.py): on
    # CPU tensors the plain version runs at any ng
    ng = cuda_cic.SMEM_LIMIT // 8 + 1
    f = torch.linspace(-1e3, 1e3, ng)
    pw = p * (ng / 64.0)
    got = cuda_cic.leapfrog_gather_push_deposit(f, pw, v, qm=QM, w=W, dt=DT,
                                                dx=DX)
    ref = cuda_cic.leapfrog_gather_push_deposit_plain(f, pw, v, qm=QM, w=W,
                                                      dt=DT, dx=DX)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("fn", ["leapfrog", "cn"])
def test_pushers_match_jax(fn):
    from pypic_tpu.push import cn_push as jcn, leapfrog_push as jlf

    _, p, v = _particles(64, edges=False)
    ep = np.random.default_rng(3).normal(size=N).astype(np.float32) * 1e3
    qm = np.float32(QM)
    jf, tf = (jlf, leapfrog_push) if fn == "leapfrog" else (jcn, cn_push)
    ref = jf(jnp.asarray(p), jnp.asarray(v), jnp.asarray(ep), jnp.float32(qm),
             DT, DT / DX)
    got = tf(*_t(p, v, ep), torch.tensor(qm), DT, DT / DX)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# the engine against pypic_tpu.engines.explicit
# ---------------------------------------------------------------------------

# ng = 1536: both packages solve with the reference's float32 spectral
# solve, whose low-k eigenvalues 2 cos(2 pi k / ng) - 2 cancel: one solve
# is 1.8e-3 from exact, and the two FFT libraries' rounding puts the
# packages' fields 4.6e-5 apart from the same rho. Over 50 steps that
# moves positions (ulp 1.2e-4 cells near p = 1536) by 2.4e-3 cells, where
# the JAX package's own fused and composed backends end 1.7e-3 apart; the
# bound there is 4e-3 cells. Velocities and energies keep their bounds.
ENGINE_CASES = [
    pytest.param(64, False, 2e-3, id="ng64"),  # p measured 5.0e-5 cells
    pytest.param(1536, False, 4e-3, id="ng1536"),  # 2.4e-3 cells
    pytest.param(64, True, 2e-3, id="per-particle-qm"),  # 4.2e-5 cells
]


@pytest.mark.parametrize("ng,per_particle,p_tol", ENGINE_CASES)
def test_engine_matches_jax(ng, per_particle, p_tol):
    ng, length, x, v, params = _two_stream_load(ng=ng)
    jcfg, tcfg = _configs(ng, length, params, backend="composed")
    n = x.shape[0]
    q = np.full(n, -E_CHARGE) if per_particle else -E_CHARGE
    m = np.full(n, M_ELECTRON) if per_particle else M_ELECTRON
    jst, jm = jrun(jexplicit.make_step(jcfg),
                   jexplicit.init_state(x, v, q, m, jcfg), STEPS)
    cuda_cic.reset_launch_counts()
    tst, tm = run(explicit.make_step(tcfg),
                  explicit.init_state(x, v, q, m, tcfg, device="cpu"), STEPS)
    assert _pos_gap(jst.p, tst.p, ng) < p_tol
    assert bool(((tst.p >= 0) & (tst.p <= ng)).all())
    np.testing.assert_allclose(tst.v.numpy(), np.asarray(jst.v), rtol=1e-4,
                               atol=1e-4 * np.abs(v).max())  # 2.2e-6
    np.testing.assert_allclose(tm.field_energy.numpy(),
                               np.asarray(jm.field_energy), rtol=1e-3)
    np.testing.assert_allclose(tm.kinetic_energy.numpy(),
                               np.asarray(jm.kinetic_energy), rtol=1e-5)
    _close(jm.current_bias, tm.current_bias, 1e-3)
    _close(jm.rho, tm.rho, 1e-3)
    assert tm.rho.shape == (STEPS, ng) and tm.e_field.shape == (STEPS, ng)
    assert int(tst.step) == STEPS and tst.step.dtype == torch.int32


def test_init_state_matches_jax():
    ng, length, x, v, params = _two_stream_load(ng=200)
    jcfg, tcfg = _configs(ng, length, params)
    j = jexplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    t = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg, device="cpu")
    np.testing.assert_array_equal(t.p.numpy(), np.asarray(j.p))
    np.testing.assert_array_equal(t.v.numpy(), np.asarray(j.v))
    _close(j.rho, t.rho, 1e-5)  # measured 0
    _close(j.e, t.e, 1e-5)
    assert t.qm_host == (t.q.item(), t.m.item())
    assert t.e.dtype == torch.float32 and int(t.step) == 0


def test_current_bias_is_the_mean_of_a_current_deposit():
    """test_engines.py:281-288: periodic CIC weights sum to 1, so the
    closed-form bias equals the grid mean of a current deposit."""
    ng, length, x, v, params = _two_stream_load(ng=64)
    _, cfg = _configs(ng, length, params)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    st, _ = run(explicit.make_step(cfg), st, 10)
    w = float(-E_CHARGE * params.p2c / cfg.grid.dx)
    j = cuda_cic.deposit(st.p, w * st.v, ng, periodic=True)
    _, m = explicit.make_step(cfg)(st)
    np.testing.assert_allclose(float(m.current_bias),
                               float(j.double().mean()), rtol=1e-3)


def test_refresh_fields_restores_the_invariant():
    ng, length, x, v, params = _two_stream_load(ng=64)
    jcfg, cfg = _configs(ng, length, params)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    shifted = st.replace(p=torch.remainder(st.p + 3.25, ng),
                         rho=torch.zeros_like(st.rho),
                         e=torch.zeros_like(st.e))
    fresh = explicit.refresh_fields(shifted, cfg)
    jst = jexplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    jfresh = jexplicit.refresh_fields(
        jst.replace(p=jnp.asarray(shifted.p.numpy())), jcfg)
    _close(jfresh.rho, fresh.rho, 1e-5)
    _close(jfresh.e, fresh.e, 1e-5)
    assert fresh.qm_host == st.qm_host


def test_explicit_landau_preset_matches_jax():
    t = presets.explicit_landau(n=3000, device="cpu")
    j = jpresets.explicit_landau(n=3000)
    assert t.name == j.name and t.meta["system"] == j.meta["system"]
    assert vars(t.meta["params"]) == vars(j.meta["params"])
    assert (t.config.grid.ng, t.config.grid.length, t.config.dt,
            t.config.p2c) == (j.config.grid.ng, j.config.grid.length,
                              j.config.dt, j.config.p2c)
    np.testing.assert_array_equal(t.state.p.numpy(), np.asarray(j.state.p))
    _close(j.state.e, t.state.e, 1e-5)
    st, m = t.make_step()(t.state)
    assert torch.isfinite(st.p).all() and m.field_energy.dim() == 0


def test_one_step_from_shared_state():
    """interop hands one JAX state to the port; a step from it agrees."""
    ng, length, x, v, params = _two_stream_load(n=4097, ng=64, seed=3)
    jcfg, tcfg = _configs(ng, length, params, backend="composed")
    jst = jexplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    d = {k: np.asarray(getattr(jst, k)) for k in interop._EXPLICIT_FIELDS}
    tst = interop.explicit_state_from_numpy(d, "cpu")
    assert tst.qm_host == (tst.q.item(), tst.m.item())
    jst1, jm = jexplicit.make_step(jcfg)(jst)
    tst1, tm = explicit.make_step(tcfg)(tst)
    assert _pos_gap(jst1.p, tst1.p, ng) < 1e-4
    _close(jst1.v, tst1.v, 1e-5)
    _close(jst1.rho, tst1.rho, 2e-5)
    _close(jst1.e, tst1.e, 5e-4)
    np.testing.assert_allclose(float(tm.field_energy), float(jm.field_energy),
                               rtol=1e-5)


def test_explicit_interop_round_trip_is_bit_exact():
    ng, length, x, v, params = _two_stream_load(n=1000, ng=32, seed=5)
    jcfg, _ = _configs(ng, length, params)
    jst = jexplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    d = {k: np.asarray(getattr(jst, k)) for k in interop._EXPLICIT_FIELDS}
    back = interop.explicit_state_to_numpy(
        interop.explicit_state_from_numpy(d, "cpu"))
    assert set(back) == set(d)
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        assert back[k].tobytes() == d[k].tobytes(), k
    with pytest.raises(KeyError):
        interop.explicit_state_from_numpy({"p": d["p"]}, "cpu")


# ---------------------------------------------------------------------------
# the answers of the config, make_step and run_resident
# ---------------------------------------------------------------------------


def test_config_errors_match_jax():
    with pytest.raises(ValueError) as jerr:
        jexplicit.ExplicitConfig(JGridSpec(16, 1.0), 1e-3, 1.0, backend="x")
    with pytest.raises(ValueError) as terr:
        explicit.ExplicitConfig(GridSpec(16, 1.0), 1e-3, 1.0, backend="x")
    assert str(terr.value) == str(jerr.value)
    cfg = explicit.ExplicitConfig(GridSpec(16, 1.0), np.float64(1e-3),
                                  np.float32(2.0))
    assert type(cfg.dt) is float and type(cfg.p2c) is float
    with pytest.raises(TypeError, match="ExplicitConfig"):
        explicit.init_state(np.zeros(4), np.zeros(4), -E_CHARGE, M_ELECTRON,
                            GridSpec(16, 1.0))


def test_axis_name_takes_the_two_stage_sweep():
    """Under axis_name (data parallel, here one rank) the fused step is the
    two-stage sweep at every ng, as the JAX engine's: it agrees with the
    one-kernel cycle to float32 rounding, and run_resident refuses it
    with JAX's ValueError."""
    from pypic_tpu_torch.tools import two_stream

    cfg, _, st = two_stream.state(4096, "cpu")
    one, m1 = explicit.make_step(cfg)(st)
    dp_cfg = dataclasses.replace(cfg, axis_name="particles")
    two, m2 = explicit.make_step(dp_cfg)(st)
    np.testing.assert_allclose(two.p.numpy(), one.p.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(two.rho.numpy(), one.rho.numpy(), rtol=1e-5,
                               atol=1e-6 * np.abs(one.rho.numpy()).max())
    assert float(m2.kinetic_energy) == pytest.approx(float(m1.kinetic_energy),
                                                     rel=1e-6)
    with pytest.raises(ValueError, match="single-device"):
        explicit.run_resident(dp_cfg, st, 2)


def test_fused_backend_rejects_per_particle_qm():
    grid = GridSpec(16, 1.0)
    cfg = explicit.ExplicitConfig(grid, 1e-9, 1.0)
    st = explicit.init_state(np.linspace(0.0, 0.9, 8), np.zeros(8),
                             np.full(8, -E_CHARGE), M_ELECTRON, cfg,
                             device="cpu")
    assert st.qm_host is None
    fused = dataclasses.replace(cfg, backend="fused")
    with pytest.raises(ValueError, match="scalar q/m"):
        explicit.make_step(fused)(st)
    st1, _ = explicit.make_step(cfg)(st)  # 'auto' takes the composed branch
    assert torch.isfinite(st1.p).all()


def test_run_resident_accepts_and_rejects_as_jax():
    ng, length, x, v, params = _two_stream_load(n=2000, ng=64)
    _, cfg = _configs(ng, length, params)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        explicit.run_resident(cfg, st, 0)
    with pytest.raises(ValueError, match=">= 1"):
        explicit.run_resident(cfg, st, 4, steps_per_call=0)
    with pytest.raises(ValueError, match="scalar q/m"):
        explicit.run_resident(cfg, st.replace(q=torch.full((2000,), -E_CHARGE)), 4)
    with pytest.raises(ValueError, match="single-device"):
        explicit.run_resident(dataclasses.replace(cfg, axis_name="x"), st, 4)
    big = dataclasses.replace(cfg, grid=GridSpec(1025, length))
    with pytest.raises(ValueError, match="ng <= 1024"):
        explicit.run_resident(big, st, 4)
    fin, m = explicit.run_resident(cfg, st, 7, steps_per_call=100)
    assert int(fin.step) == 7 and m.field_energy.shape == (7,)


# ---------------------------------------------------------------------------
# entry points run on the card unless told otherwise
# ---------------------------------------------------------------------------


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_a_card_raise(monkeypatch):
    _no_card(monkeypatch)
    grid = GridSpec(16, 1.0)
    x = np.linspace(0.0, 0.9, 8)
    ecfg = explicit.ExplicitConfig(grid, 1e-9, 1.0)
    icfg = implicit.ImplicitConfig(grid, 1e-9, 1.0)
    calls = [
        lambda: explicit.init_state(x, np.zeros(8), -E_CHARGE, M_ELECTRON, ecfg),
        lambda: implicit.init_state(x, np.zeros(8), -E_CHARGE, M_ELECTRON, icfg),
        lambda: presets.landau_damping(n=100),
        lambda: presets.two_stream(n=100),
        lambda: presets.explicit_landau(n=100),
        lambda: grid.nodes(),
        lambda: two_stream.state(100, None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_default_device_is_the_card_and_tensors_keep_theirs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert devices.resolve() == torch.device("cuda")
    assert devices.resolve("cpu") == torch.device("cpu")
    assert devices.resolve(like=torch.zeros(2)) == torch.device("cpu")
    cfg = explicit.ExplicitConfig(GridSpec(16, 1.0), 1e-9, 1.0)
    st = explicit.init_state(torch.linspace(0.0, 0.9, 8), torch.zeros(8),
                             -E_CHARGE, M_ELECTRON, cfg)
    assert st.p.device.type == "cpu" and st.e.device.type == "cpu"


def test_two_stream_device_load():
    """tools.two_stream's load has the numpy loader's distribution."""
    cfg, params, st = two_stream.state(20_000, "cpu", ng=64)
    ng, length, x, v, _ = _two_stream_load(ng=64)
    assert cfg.grid.ng == 64 and cfg.grid.length == length
    assert bool(((st.p >= 0) & (st.p < ng)).all())
    vte = np.sqrt(params.kbte / M_ELECTRON)
    vt = st.v.double().numpy()
    assert abs(vt[:10_000].mean() + 2 * vte) < 0.02 * vte
    assert abs(vt[10_000:].mean() - 2 * vte) < 0.02 * vte
    assert abs(vt[:10_000].std() - 0.5 * vte) < 0.02 * vte
    # the cosine perturbation: same per-cell counts as the numpy load
    h_dev = np.histogram(st.p.numpy(), bins=ng, range=(0, ng))[0]
    h_np = np.histogram(x / cfg.grid.dx, bins=ng, range=(0, ng))[0]
    assert np.abs(np.fft.rfft(h_dev)[1]) == pytest.approx(
        np.abs(np.fft.rfft(h_np)[1]), rel=0.3)
