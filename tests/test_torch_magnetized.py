"""The magnetized Boltzmann-electron slice of pypic_tpu_torch against
pypic_tpu.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode, as tests/test_pallas.py runs them) and the port's
counterpart (its plain kernel versions: the tensors lie on the CPU). Each
tolerance is stated beside its test. The engine step runs from one JAX
state in both packages, the JAX re-activation draws replayed in the port
through ``make_step(source_draws=...)``: jax.random streams cannot be
reproduced in PyTorch.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import sources as jsources
from pypic_tpu.constants import E_CHARGE, EV_TO_K, K_BOLTZMANN, M_PROTON
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.ops import fd as jfd
from pypic_tpu.ops import poisson as jpoisson
from pypic_tpu.ops import tridiag as jtridiag
from pypic_tpu.ops.pallas_cic import (_DEFAULT_BLOCK, boris_gather_push_pallas,
                                      deposit2_pallas)
from pypic_tpu.ops.pallas_newton import boltzmann_dirichlet_pallas
from pypic_tpu.ops.pallas_rng import source_batch_pallas
from pypic_tpu.presets import pic_iead as jpic_iead
from pypic_tpu.push import boris_push_dt as jboris_push_dt

from pypic_tpu_torch import interop, presets
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, cuda_newton, cuda_rng, fd, poisson, tridiag
from pypic_tpu_torch.push import boris_push_dt
from pypic_tpu_torch.runner import run


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ref, got, rel):
    """|got - ref| <= rel * max|ref|."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# grid operators and solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ng", [16, 600])
def test_bounded_grid_operators(ng):
    """smooth_bounded and grad_neg_bounded: the same float32 operations in
    the same order (1e-6 of the largest magnitude)."""
    f = (np.random.default_rng(ng).normal(size=ng) * 1e3).astype(np.float32)
    _close(jfd.smooth_bounded(jnp.asarray(f)), fd.smooth_bounded(_t(f)), 1e-6)
    _close(jfd.grad_neg_bounded(jnp.asarray(f), 2.5e-6),
           fd.grad_neg_bounded(_t(f), 2.5e-6), 1e-6)


@pytest.mark.parametrize("k", [0, 2])
def test_solve_tridiag_thomas(k):
    """The Thomas sweeps in JAX's operation order, one and two right-hand
    sides, float32 (1e-5 of the largest magnitude)."""
    rng = np.random.default_rng(3 + k)
    n = 64
    dl, du = (rng.uniform(0.1, 1, n).astype(np.float32) for _ in range(2))
    d = (rng.uniform(2.5, 4, n)).astype(np.float32)
    b = rng.normal(size=(n, k) if k else n).astype(np.float32)
    ref = jtridiag.solve_tridiag(*(jnp.asarray(a) for a in (dl, d, du, b)),
                                 method="thomas")
    got = tridiag.solve_tridiag(*(_t(a) for a in (dl, d, du, b)),
                                method="thomas")
    assert got.shape == b.shape and got.dtype == torch.float32
    _close(ref, got, 1e-5)


def _newton_case(ng, rng):
    """tests/test_pallas.py:315-342's inputs."""
    dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
    return (E_CHARGE * dens).astype(np.float32)


TE_N, DX_N, N0_N = 11600.0 * 10.0, 2e-5, np.float32(1e17)


@pytest.mark.parametrize("ng", [600, 301, 128])
def test_solve_boltzmann_dirichlet_matches_jax(ng):
    """The op-composed Newton route (Thomas steps) against JAX's on the
    CPU, cold and warm (from the converged answer): the same algorithm
    and order, so the iteration counts are equal and phi agrees to 1e-5
    of max|phi| (float32 Thomas sums, exp and dot in two libraries)."""
    rho = _newton_case(ng, np.random.default_rng(11 + ng))
    ref = jpoisson.solve_boltzmann_dirichlet(jnp.asarray(rho), N0_N, TE_N,
                                             DX_N, tol=1e-9)
    got = poisson.solve_boltzmann_dirichlet(_t(rho), float(N0_N), TE_N, DX_N,
                                            tol=1e-9)
    scale = float(jnp.max(jnp.abs(ref.phi)))
    assert int(got.iterations) == int(ref.iterations)
    assert float(got.residual) <= 1e-9
    _close(ref.phi, got.phi, 1e-5)
    ref_w = jpoisson.solve_boltzmann_dirichlet(jnp.asarray(rho), N0_N, TE_N,
                                               DX_N, tol=1e-9, phi0=ref.phi)
    got_w = poisson.solve_boltzmann_dirichlet(_t(rho), float(N0_N), TE_N,
                                              DX_N, tol=1e-9,
                                              phi0=_t(ref.phi))
    assert int(got_w.iterations) == int(ref_w.iterations)
    np.testing.assert_allclose(got_w.phi.numpy(), np.asarray(ref_w.phi),
                               rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("ng", [600, 301, 128])
def test_boltzmann_dirichlet_plain_matches_pallas(ng):
    """The kernel's plain version against boltzmann_dirichlet_pallas in
    interpret mode: test_pallas.py:315-342's cases and criteria. The same
    PCR loop in the same order; at a tol at the float32 floor the counts
    may differ by one (test_pallas.py admits ref + 1), phi within 3e-5 of
    max|phi|; warm from the answer, the counts are equal."""
    rho = _newton_case(ng, np.random.default_rng(11 + ng))
    ref = boltzmann_dirichlet_pallas(jnp.asarray(rho), N0_N, TE_N, DX_N,
                                     tol=1e-9)
    got = cuda_newton.boltzmann_dirichlet(_t(rho), float(N0_N), TE_N, DX_N,
                                          tol=1e-9)
    assert got.phi.dtype == torch.float32 and got.phi.shape == (ng,)
    assert got.iterations.dtype == torch.int32
    assert float(got.residual) <= 1e-9
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    scale = float(jnp.max(jnp.abs(ref.phi)))
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(ref.phi), rtol=0,
                               atol=3e-5 * scale)
    ref_w = boltzmann_dirichlet_pallas(jnp.asarray(rho), N0_N, TE_N, DX_N,
                                       tol=1e-9, phi0=ref.phi)
    got_w = cuda_newton.boltzmann_dirichlet(_t(rho), torch.tensor(N0_N),
                                            TE_N, DX_N, tol=1e-9,
                                            phi0=_t(ref.phi))
    assert int(got_w.iterations) == int(ref_w.iterations)
    np.testing.assert_allclose(got_w.phi.numpy(), np.asarray(ref_w.phi),
                               rtol=0, atol=3e-5 * scale)


def test_boltzmann_dirichlet_plain_neutral_plasma():
    """test_pallas.py:345-358: a neutral plasma at sheath scales converges
    to |phi| < 1e-4 Te."""
    rho = torch.full((129,), E_CHARGE * 1e17, dtype=torch.float32)
    res = cuda_newton.boltzmann_dirichlet(rho, float(N0_N), TE_N, DX_N,
                                          tol=1e-9)
    te_volts = K_BOLTZMANN * TE_N / E_CHARGE
    assert float(res.phi.abs().max()) < 1e-4 * te_volts


def test_boltzmann_dirichlet_rejects_large_grids():
    """The 1,024-row limit is the kernel's (one CTA, a row a thread): on
    CPU tensors the wrapper runs the plain PCR loop at ng = 1025 (ngp =
    2048) and returns its answer, bit-equal, with no launch counted;
    tests/test_torch_cuda.py holds the raise on the card."""
    rho = torch.from_numpy(_newton_case(1025, np.random.default_rng(5)))
    before = cuda_cic.LAUNCHES["boltzmann_dirichlet"]
    got = cuda_newton.boltzmann_dirichlet(rho, float(N0_N), TE_N, DX_N)
    ref = cuda_newton.boltzmann_dirichlet_plain(rho, float(N0_N), TE_N, DX_N)
    assert torch.equal(got.phi, ref.phi) and got.phi.shape == (1025,)
    assert int(got.iterations) == int(ref.iterations)
    assert float(got.residual) <= 1e-9
    assert cuda_cic.LAUNCHES["boltzmann_dirichlet"] == before


def test_tridiag_d_n_variants_not_ported():
    z = torch.ones(8)
    with pytest.raises(NotImplementedError, match="pscan"):
        tridiag.solve_tridiag(z, z, z, z, method="pscan")


# ---------------------------------------------------------------------------
# particle kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("periodic", [False, True])
def test_deposit2_plain_matches_pallas(periodic):
    """deposit2's plain version against deposit2_pallas, rows off the grid
    (p < 0, p > ng - 1: wall-lost slots) carrying weight 0. Relative to the
    largest node 2e-6 (two float32 sums in different orders)."""
    rng = np.random.default_rng(1)
    ng, n = 600, 20_000
    p = rng.uniform(0, ng - 1, n).astype(np.float32)
    va = rng.normal(size=n).astype(np.float32)
    vb = rng.uniform(0, 2, n).astype(np.float32)
    off = np.arange(0, n, 97)
    p[off] = np.where(off % 2, -0.4, ng - 1 + 0.3).astype(np.float32)
    va[off] = 0.0
    vb[off] = 0.0
    a_ref, b_ref = deposit2_pallas(*(jnp.asarray(x) for x in (p, va, vb)), ng,
                                   periodic=periodic)
    a, b = cuda_cic.deposit2(_t(p), _t(va), _t(vb), ng, periodic=periodic)
    _close(a_ref, a, 2e-6)
    _close(b_ref, b, 2e-6)
    a1 = cuda_cic.deposit(_t(p), _t(va), ng, periodic=periodic)
    assert torch.equal(a, a1)


@pytest.mark.parametrize("swap", [False, True])
def test_boris_gather_push_plain_matches_pallas(swap):
    """test_pallas.py:232-262's inputs with edge rows at 0 and ng - 1. The
    same float32 operations: positions within 1e-6 cells, velocities 1e-5
    of the largest (the TPU kernel's window gather rounds its tent weights
    otherwise); inactive rows bit-equal to their inputs."""
    rng = np.random.default_rng(2)
    ng, n = 128, 20_000
    dx, dt = 1e-5, 1e-10
    field = rng.normal(0, 100, ng).astype(np.float32)
    p = rng.uniform(0, ng - 1, n).astype(np.float32)
    p[:4] = [0.0, ng - 1, 0.5, ng - 1.5]
    v = rng.normal(0, 1e4, (n, 3)).astype(np.float32)
    cs = rng.integers(1, 3, n).astype(np.float32)
    m = np.full(n, 2.0 * M_PROTON, np.float32)
    act = (rng.uniform(size=n) < 0.9).astype(np.float32)
    b = (1.2, 0.7, -0.3)
    const = ((0.5 * dt * E_CHARGE) * jnp.asarray(cs) / jnp.asarray(m))
    ref = boris_gather_push_pallas(
        jnp.asarray(field), jnp.asarray(p), *(jnp.asarray(v[:, i]) for i in range(3)),
        const, jnp.asarray(act), b=b, dt=dt, dt_dx=dt / dx, swap_weights=swap)
    got = cuda_cic.boris_gather_push(
        _t(field), _t(p), *(_t(v[:, i]) for i in range(3)), _t(const),
        _t(act), b=b, dt_dx=dt / dx, swap_weights=swap)
    live = act > 0
    np.testing.assert_allclose(got[0].numpy()[live], np.asarray(ref[0])[live],
                               rtol=0, atol=1e-6 * ng)
    for r, g in zip(ref[1:], got[1:]):
        _close(np.asarray(r)[live], g.numpy()[live], 1e-5)
    for i, g in enumerate(got):
        held = p if i == 0 else v[:, i - 1]
        np.testing.assert_array_equal(g.numpy()[~live], held[~live])


def test_boris_push_dt_matches_jax():
    """The composed push: the same float32 operations in the same order
    (1e-6 of the largest)."""
    rng = np.random.default_rng(5)
    n, dt = 5000, 1e-10
    x = rng.uniform(0, 1e-2, n).astype(np.float32)
    yz = rng.normal(0, 1e-3, (n, 2)).astype(np.float32)
    v = rng.normal(0, 1e4, (n, 3)).astype(np.float32)
    ex = rng.normal(0, 1e5, n).astype(np.float32)
    cs = rng.integers(1, 6, n).astype(np.float32)
    m = np.full(n, 10.81 * M_PROTON, np.float32)
    b = np.asarray([0.14, 1.99, 0.0], np.float32)
    ref = jboris_push_dt(*(jnp.asarray(a) for a in (x, yz, v, ex, b, cs, m)), dt)
    got = boris_push_dt(*(_t(a) for a in (x, yz, v, ex, b, cs, m)), dt)
    for r, g in zip(ref, got):
        _close(r, g, 1e-6)


def test_source_batch_transform_matches_pallas():
    """The transform alone on the bits the JAX kernel draws in interpret
    mode (jax.random.bits(key, (nb, 4, block))): the uniforms are exact;
    log, sin and cos of two libraries put the normals a few float32 ulps
    apart (x within 1e-6 of L, velocities 1e-6 of the largest)."""
    n, length, vth, vx = 20_000, 3e-3, 2.2e4, 3e3
    key = jax.random.PRNGKey(4)
    kw = dict(x_mu=length / 2, x_sigma=length / 12, x_wrap=length, vth=vth,
              vx=vx)
    ref = source_batch_pallas(jnp.uint32(4), key, n, **kw)
    nb = -(-n // _DEFAULT_BLOCK)
    bits = np.asarray(jax.random.bits(key, (nb, 4, _DEFAULT_BLOCK), jnp.uint32))
    bits = bits.transpose(1, 0, 2).reshape(4, -1)[:, :n].astype(np.int64)
    got = cuda_rng.source_batch_from_bits_plain(torch.from_numpy(bits), **kw)
    dxw = np.abs(got[0].numpy().astype(np.float64) - np.asarray(ref[0]))
    assert np.minimum(dxw, length - dxw).max() <= 1e-6 * length
    for r, g in zip(ref[1:], got[1:]):
        _close(r, g, 1e-6)


def test_philox_known_answer_and_moments():
    """Philox4x32-10 against Random123's known-answer vectors, and the
    source batch's moments (tests/test_magnetized.py:191-219's checks)."""
    kat = {((0, 0), (0, 0, 0, 0)): (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8),
           ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 4):
               (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
           ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)):
               (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)}
    for (key, ctr), want in kat.items():
        got = cuda_rng.philox4x32_plain(key, ctr)
        assert tuple(int(w) for w in got) == want

    ti, mass, vx = 10.0 * EV_TO_K, M_PROTON, 3e4
    vth = np.sqrt(K_BOLTZMANN * ti / mass)
    x, ux, uy, uz = cuda_rng.source_batch(
        (0, 9), 3, 200_000, x_mu=0.5, x_sigma=1.0 / 12.0, x_wrap=1.0,
        vth=float(vth), vx=vx, device="cpu")
    x = x.double().numpy()
    assert (x >= 0).all() and (x <= 1.0).all()
    assert abs(x.mean() - 0.5) < 0.01
    assert abs(x.std() - 1.0 / 12.0) < 0.005
    for comp in (ux, uy, uz):
        c = comp.double().numpy()
        assert abs(c.std() - vth) < 0.02 * vth
        assert abs(c.mean() - vx) < 0.02 * vth
        z = (c - c.mean()) / c.std()
        assert abs((z**3).mean()) < 0.05
        assert abs((z**4).mean() - 3.0) < 0.1
    u = cuda_rng.source_uniforms((0, 9), 3, 1000, device="cpu")
    assert u.dtype == torch.float32 and (u > 0).all() and (u < 1).all()
    # counters differ by step and by slot
    u2 = cuda_rng.source_uniforms((0, 9), 4, 1000, device="cpu")
    assert not torch.equal(u, u2)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def iead_pair():
    """pic_iead(n_per_species=500) in both packages, and the JAX state
    after one step of the preset's configuration."""
    jpre = jpic_iead(n_per_species=500)
    tpre = presets.pic_iead(n_per_species=500, device="cpu")
    js1, _ = jmag.make_step(jpre.config)(jpre.state)
    return jpre, tpre, js1


def test_pic_iead_preset_state_matches_jax(iead_pair):
    """The same numpy draws: the initial states are identical, and the
    port's Philox key is the JAX key data."""
    jpre, tpre, _ = iead_pair
    ref = {k: np.asarray(getattr(jpre.state, k)) for k in
           interop._MAGNETIZED_FIELDS}
    got = interop.magnetized_state_to_numpy(tpre.state)
    for k, a in ref.items():
        assert got[k].dtype == a.dtype, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    np.testing.assert_array_equal(got["rng"], np.asarray(jpre.state.rng))
    assert tpre.meta["floating_potential"] == jpre.meta["floating_potential"]
    assert tpre.config.b == jpre.config.b


def test_interop_round_trip_is_bit_exact(iead_pair):
    _, _, st = iead_pair
    d = {k: np.asarray(getattr(st, k)) for k in
         interop._MAGNETIZED_FIELDS + ("rng",)}
    tst = interop.magnetized_state_from_numpy(d, "cpu")
    assert tst.step_host == 1 and tst.rng == tuple(int(w) for w in d["rng"])
    back = interop.magnetized_state_to_numpy(tst)
    assert set(back) == set(d)
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)


def _replay(jstate, jcfg):
    """The JAX step's own source batch (threefry, 'auto' on the CPU) as
    the port's source_draws."""
    _, _, k_src, _ = jax.random.split(jstate.rng, 4)
    src = jcfg.source
    n = jstate.p.shape[0]
    batch = jsources.sample_source_6d(k_src, n, jcfg.grid, src.ti, src.mass,
                                      vx=src.vx, components=True)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    def source_draws(step, n_draw):
        assert n_draw == n
        return draws
    return source_draws


def _step_pair(jcfg, tcfg, jstate):
    js, jm = jmag.make_step(jcfg)(jstate)
    d = {k: np.asarray(getattr(jstate, k)) for k in
         interop._MAGNETIZED_FIELDS + ("rng",)}
    tstate = interop.magnetized_state_from_numpy(d, "cpu")
    ts, tm = magnetized.make_step(tcfg, source_draws=_replay(jstate, jcfg))(tstate)
    return js, jm, ts, tm


def _assert_step_close(js, jm, ts, tm):
    """tests/test_magnetized.py:461-489's limits: rho rtol 1e-4, phi rtol
    1e-3 (atol 1e-8), active positions rtol 2e-5 (atol 1e-5), velocities
    rtol 2e-4 (atol 1), equal active counts."""
    np.testing.assert_allclose(tm.rho.numpy(), np.asarray(jm.rho), rtol=1e-4)
    np.testing.assert_allclose(tm.phi.numpy(), np.asarray(jm.phi), rtol=1e-3,
                               atol=1e-8)
    act = np.asarray(js.active) == 1
    np.testing.assert_allclose(ts.p.numpy()[act], np.asarray(js.p)[act],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy()[act], np.asarray(js.v)[act],
                               rtol=2e-4, atol=1.0)
    assert int(ts.active.sum()) == int(np.asarray(js.active).sum())
    assert int(tm.n_reactivated) == int(jm.n_reactivated)
    assert int(tm.n_hit_wall) == int(jm.n_hit_wall)
    np.testing.assert_allclose(float(tm.n0), float(jm.n0), rtol=1e-5)


@pytest.mark.parametrize("newton", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_engine_step_matches_jax(iead_pair, backend, newton):
    """One step of pic_iead from JAX's state after one step (so the n0
    recurrence's later branch runs and some slots re-activate), with the
    same backend and Newton route on each side."""
    jpre, _, js1 = iead_pair
    jcfg = dc.replace(jpre.config, backend=backend, newton_backend=newton)
    tcfg = magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source")},
        grid=GridSpec(jcfg.grid.ng, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(jcfg.source)))
    js, jm, ts, tm = _step_pair(jcfg, tcfg, js1)
    assert int(jm.n_reactivated) > 0
    _assert_step_close(js, jm, ts, tm)
    assert int(tm.newton_iters) == int(jm.newton_iters)


@pytest.mark.parametrize("opts", [
    dict(smooth_rho=True), dict(newton_warm="extrapolate"),
    dict(gather_weights="cic"), dict(eta_in_volts=True),
    dict(react_timing="immediate")], ids=lambda o: next(iter(o)))
def test_engine_step_options_match_jax(iead_pair, opts):
    """The engine's other options, one step each (fused, Newton kernel's
    plain version against Pallas interpret), at the limits above."""
    jpre, _, js1 = iead_pair
    jcfg = dc.replace(jpre.config, backend="fused", newton_backend="pallas",
                      **opts)
    tcfg = magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source")},
        grid=GridSpec(jcfg.grid.ng, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(jcfg.source)))
    js, jm, ts, tm = _step_pair(jcfg, tcfg, js1)
    _assert_step_close(js, jm, ts, tm)


def _tcfg(**kw):
    return dc.replace(presets.pic_iead(n_per_species=64, device="cpu").config,
                      **kw)


def test_react_timing_reference_vs_immediate():
    """tests/test_magnetized.py:956-983 on the port: a planted wall loss
    re-enters in the next step ('reference') or in the same step
    ('immediate')."""
    pre = presets.pic_iead(n_per_species=64, device="cpu")
    cfg = dc.replace(pre.config, newton_backend="pallas")
    p = pre.state.p.clone()
    vx = pre.state.vx.clone()
    p[0] = 0.05
    vx[0] = -0.2 * cfg.grid.dx / cfg.dt  # 0.2 cells/step inbound
    st = pre.state.replace(p=p, vx=vx)
    for timing, expect_first in (("reference", 0), ("immediate", 1)):
        step = magnetized.make_step(dc.replace(cfg, react_timing=timing))
        s1, m1 = step(st)
        assert int(m1.n_hit_wall) >= 1, timing
        assert int(m1.n_reactivated) == expect_first, timing
        s2, m2 = step(s1)
        assert int((s2.active != 1).sum()) == int(m2.n_hit_wall), timing


def test_population_invariant_over_50_steps():
    """tests/test_magnetized.py:341-353 on the port's own sampler: each
    step's active count plus its wall losses is constant, and each step's
    re-activations equal the previous step's losses."""
    pre = presets.pic_iead(n_per_species=500, device="cpu")
    cfg = dc.replace(pre.config, newton_backend="pallas")
    fin, m = run(magnetized.make_step(cfg), pre.state, 50)
    tot = (m.n_active + m.n_hit_wall).numpy()
    assert (tot == tot[0]).all()
    np.testing.assert_array_equal(m.n_reactivated.numpy()[1:],
                                  m.n_hit_wall.numpy()[:-1])
    assert int(m.n_hit_wall.sum()) > 0
    assert fin.step_host == 50 and int(fin.step) == 50
    assert torch.isfinite(m.phi).all()


def test_philox_sampler_matches_threefry_physics():
    """tests/test_magnetized.py:221-230: pic_iead(n_per_species=400) over
    30 steps, the port's Philox sampler against the JAX engine's threefry
    one: mean phi_max over steps 5-29 within 5%."""
    from pypic_tpu.runner import run as jrun

    jpre = jpic_iead(n_per_species=400)
    _, jm = jrun(jmag.make_step(jpre.config), jpre.state, 30)
    pre = presets.pic_iead(n_per_species=400, device="cpu")
    cfg = dc.replace(pre.config, newton_backend="pallas")
    _, m = run(magnetized.make_step(cfg), pre.state, 30)
    np.testing.assert_allclose(m.phi_max[5:].double().mean().item(),
                               np.asarray(jm.phi_max, np.float64)[5:].mean(),
                               rtol=0.05)


@pytest.mark.parametrize("kw, match", [
    (dict(source_sampler="bogus"), "source_sampler"),
    (dict(newton_warm="bogus"), "newton_warm"),
    (dict(gather_weights="bogus"), "gather_weights"),
    (dict(newton_backend="bogus"), "newton_backend"),
    (dict(pusher="bogus"), "pusher"),
    (dict(react_batch=-1), "react_batch"),
    (dict(react_timing="bogus"), "react_timing"),
    (dict(carried_deposit="bogus"), "carried_deposit"),
    (dict(pusher="gc", backend="fused"), "does not support pusher"),
    (dict(source_sampler="pallas", reactivate="flux"), "flux-source"),
])
def test_config_value_errors(kw, match):
    """The JAX config's ValueErrors, raised by the port's as well."""
    for mod, grid in ((jmag, jpic_iead(n_per_species=8).config.grid),
                      (magnetized, _tcfg().grid)):
        base = dict(grid=grid, dt=1e-10, te=1e5, b=(0.1, 2.0, 0.0),
                    species_z=(1, 5))
        with pytest.raises(ValueError, match=match):
            mod.MagnetizedConfig(**base, **kw)


@pytest.mark.parametrize("kw, item", [
    (dict(ionization=True), "item 14b"),
    (dict(reactivate="capped-source"), "item 14b"),
    (dict(react_batch=64), "item 18"),
    (dict(carried_deposit="on", react_batch=64), "item 18"),
    (dict(impact_buffer_size=8), "item 14b"),
    (dict(bca_escape=True), "item 14b"),
    (dict(axis_name="p", source_sampler="hash"), "item 17"),
    (dict(source_sampler="hash"), "item 14b"),
    (dict(source_sampler="threefry"), "item 14b"),
    (dict(deposit_method="scatter"), "item 18"),
])
def test_unported_options_raise(kw, item):
    cfg = _tcfg(**kw)
    with pytest.raises(NotImplementedError, match=item):
        magnetized.make_step(cfg)
    with pytest.raises(NotImplementedError, match=item):
        magnetized.init_state(np.zeros(4), np.zeros((4, 3)), 1.0, 1.0, 1.0,
                              0, cfg, device="cpu")


def test_row_tool_runs_on_the_cpu():
    """tools/magnetized.run_row drives the row's path (here the plain
    versions, a few steps at a small n); on the CPU it launches no kernel
    and its checks see the population kept."""
    from pypic_tpu_torch.tools import magnetized as row

    res, cfg, fin, m = row.run_row("cpu", steps=8, n_per_species=300,
                                   warmup=1, newton_backend="pallas")
    assert res["n"] == 1800 and res["steps"] == 8 and res["launches"] == {}
    assert res["device"] == "cpu" and 1.0 <= res["newton_mean"]
    problems = row.check_row(cfg, fin, m)
    assert not [p for p in problems if "IEAD" not in p], problems
    assert fin.step_host == 8


def test_dirichlet_solve_matches_jax():
    """The linear Dirichlet solve (Thomas, shifted to min 0): 1e-5 of the
    largest magnitude."""
    rho = (np.random.default_rng(8).normal(size=200) * 1e-3).astype(np.float32)
    _close(jpoisson.solve_dirichlet(jnp.asarray(rho), 1e-3),
           poisson.solve_dirichlet(_t(rho), 1e-3), 1e-5)
