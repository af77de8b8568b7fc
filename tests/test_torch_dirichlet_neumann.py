"""The Dirichlet-Neumann flux sheath of pypic_tpu_torch against pypic_tpu:
the rank-1 tridiagonal solves, the D-N Newton solve (the op-composed
Thomas route and the one-launch kernel's plain version), the wall-flux
source, the row compaction and the engine's D-N step
(``dirichlet_neumann_test``, pygcpic.py:1968-2093).

The same numpy inputs go through both packages; the JAX Pallas kernel
runs in interpret mode. The JAX engine's flux draws (threefry, 'auto' on
the CPU) are replayed in the port through ``make_step(source_draws=...)``.
Each tolerance is stated beside its test.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.constants import EV_TO_K, K_BOLTZMANN, M_PROTON
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.ops import poisson as jpoisson
from pypic_tpu.ops import tridiag as jtridiag
from pypic_tpu.ops.pallas_newton import boltzmann_dn_pallas
from pypic_tpu.utils import compact_rows as jcompact_rows

from pypic_tpu_torch import interop, presets, sources
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, cuda_newton, cuda_rng, poisson, tridiag
from pypic_tpu_torch.runner import run
from pypic_tpu_torch.utils import compact_rows


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ref, got, rel):
    """|got - ref| <= rel * max|ref|."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# tridiagonal solves
# ---------------------------------------------------------------------------


def _system(n, seed):
    rng = np.random.default_rng(seed)
    dl, du = (rng.uniform(0.1, 1, n).astype(np.float32) for _ in range(2))
    d = rng.uniform(2.5, 4, n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return dl, d, du, b


def test_solve_tridiag_rank1_matches_jax():
    """Sherman-Morrison over a two-column Thomas solve, the D-N
    Laplacian's rank-1 term (u = e_{n-1}, v = e_{n-3}): JAX's operation
    order in float32, 1e-5 of the largest magnitude."""
    n = 64
    dl, d, du, b = _system(n, 21)
    u = np.zeros(n, np.float32)
    u[-1] = 1.0
    v = np.zeros(n, np.float32)
    v[-3] = 1.0
    ref = jtridiag.solve_tridiag_rank1(*(jnp.asarray(a) for a in (dl, d, du, b, u, v)))
    got = tridiag.solve_tridiag_rank1(*(_t(a) for a in (dl, d, du, b, u, v)))
    assert got.dtype == torch.float32 and got.shape == (n,)
    _close(ref, got, 1e-5)


@pytest.mark.parametrize("corners", [(1.0, 1.0), (0.5, -0.7)])
def test_solve_cyclic_tridiag_matches_jax(corners):
    """Wrap corners A[0, n-1], A[n-1, 0] as a rank-1 term (the periodic
    Newton Jacobian's): 1e-5 of the largest magnitude, and the answer
    solves the dense system."""
    n = 48
    dl, d, du, b = _system(n, 22)
    ref = jtridiag.solve_cyclic_tridiag(*(jnp.asarray(a) for a in (dl, d, du, b)),
                                        *corners)
    got = tridiag.solve_cyclic_tridiag(*(_t(a) for a in (dl, d, du, b)), *corners)
    _close(ref, got, 1e-5)
    a = np.diag(d.astype(np.float64)) + np.diag(dl[1:].astype(np.float64), -1) \
        + np.diag(du[:-1].astype(np.float64), 1)
    a[0, -1], a[-1, 0] = corners
    _close(b, a @ got.double().numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the D-N Newton solve
# ---------------------------------------------------------------------------

TE_N, DX_N, N0_N = 11600.0 * 10.0, 2e-5, np.float32(0.9e17)


def _dn_case(ng):
    """tests/test_pallas.py:361-389's inputs: a number density."""
    rng = np.random.default_rng(13 + ng)
    return (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15).astype(np.float32)


@pytest.mark.parametrize("ng", [600, 257])
def test_solve_boltzmann_dirichlet_neumann_matches_jax(ng):
    """The op-composed route (Thomas + Sherman-Morrison) against JAX's on
    the CPU, cold and warm (from the converged answer): the same algorithm
    and order, equal iteration counts, phi within 1e-4 of max|phi| (float32
    Thomas sums, exp and norm in two libraries; measured 2e-5)."""
    n = _dn_case(ng)
    zero = np.zeros(ng, np.float32)
    ref = jpoisson.solve_boltzmann_dirichlet_neumann(
        jnp.asarray(n), N0_N, TE_N, DX_N, jnp.asarray(zero))
    got = poisson.solve_boltzmann_dirichlet_neumann(
        _t(n), float(N0_N), TE_N, DX_N, _t(zero))
    assert int(got.iterations) == int(ref.iterations)
    assert float(got.residual) <= 1e-3
    _close(ref.phi, got.phi, 1e-4)
    ref_w = jpoisson.solve_boltzmann_dirichlet_neumann(
        jnp.asarray(n), N0_N, TE_N, DX_N, ref.phi)
    got_w = poisson.solve_boltzmann_dirichlet_neumann(
        _t(n), float(N0_N), TE_N, DX_N, _t(ref.phi))
    assert int(got_w.iterations) == int(ref_w.iterations)
    _close(ref_w.phi, got_w.phi, 1e-4)


@pytest.mark.parametrize("ng", [600, 257])
def test_boltzmann_dn_plain_matches_pallas(ng):
    """The kernel's plain version against boltzmann_dn_pallas in interpret
    mode and against JAX's Thomas route: test_pallas.py:361-389's criteria
    (iterations within one cold, equal warm; phi within 5e-4 of max|phi|).
    On CPU tensors the wrapper is the plain version and counts no launch."""
    n = _dn_case(ng)
    zero = np.zeros(ng, np.float32)
    pal = boltzmann_dn_pallas(jnp.asarray(n), N0_N, TE_N, DX_N, jnp.asarray(zero))
    thomas = jpoisson.solve_boltzmann_dirichlet_neumann(
        jnp.asarray(n), N0_N, TE_N, DX_N, jnp.asarray(zero))
    before = dict(cuda_cic.LAUNCHES)
    got = cuda_newton.boltzmann_dn(_t(n), torch.tensor(N0_N), TE_N, DX_N, _t(zero))
    assert cuda_cic.LAUNCHES == before
    assert got.phi.dtype == torch.float32 and got.phi.shape == (ng,)
    assert got.iterations.dtype == torch.int32 and float(got.residual) <= 1e-3
    for ref in (pal, thomas):
        assert abs(int(got.iterations) - int(ref.iterations)) <= 1
        _close(ref.phi, got.phi, 5e-4)
    pal_w = boltzmann_dn_pallas(jnp.asarray(n), N0_N, TE_N, DX_N, thomas.phi)
    got_w = cuda_newton.boltzmann_dn(_t(n), float(N0_N), TE_N, DX_N, _t(thomas.phi))
    assert int(got_w.iterations) == int(pal_w.iterations)
    _close(pal_w.phi, got_w.phi, 5e-4)


def test_boltzmann_dn_checks_its_inputs():
    z = torch.zeros(16)
    with pytest.raises(ValueError, match="shape"):
        cuda_newton.boltzmann_dn(z, 1e17, TE_N, DX_N, z[:-1])
    # float32 or float64 (the double kernel of a float64 state), one dtype
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_newton.boltzmann_dn(z.half(), 1e17, TE_N, DX_N, z.half())
    with pytest.raises(TypeError, match="different dtypes"):
        cuda_newton.boltzmann_dn(z, 1e17, TE_N, DX_N, z.double())
    with pytest.raises(ValueError, match="ng >= 3"):
        cuda_newton.boltzmann_dn(z[:2], 1e17, TE_N, DX_N, z[:2])


# ---------------------------------------------------------------------------
# the wall-flux source
# ---------------------------------------------------------------------------

TI = 10.0 * EV_TO_K


@pytest.mark.parametrize("ti, vx", [(TI, 0.0), (3.0 * EV_TO_K, 2e4)])
def test_flux_table_matches_jax(ti, vx):
    """The speed table equals jnp.linspace's float32 table bit for bit;
    the CDF is within 4 float32 ulps of JAX's (its sums in another
    order)."""
    vth = float(np.sqrt(K_BOLTZMANN * ti / M_PROTON))
    ref = np.asarray(jnp.linspace(-6.0 * vth, 6.0 * vth, 100, dtype=jnp.float32))
    t = sources.flux_table(ti, M_PROTON, vx)
    np.testing.assert_array_equal(t.vels.view(np.uint32), ref.view(np.uint32))
    w = (jnp.exp(-((jnp.asarray(ref) - vx) ** 2) / (2.0 * vth * vth))
         * jnp.abs(jnp.asarray(ref)))
    cdf = np.asarray(jnp.cumsum(w) / jnp.sum(w), np.float32)
    gap = np.abs(cdf.view(np.int32).astype(np.int64)
                 - t.cdf.view(np.int32).astype(np.int64))
    assert gap.max() <= 4
    assert t.dvel == float(ref[1] - ref[0])


def test_flux_transform_matches_hash_sampler():
    """The transform on JAX's own hash uniforms against
    sample_flux_6d_hash: x and the table draws exact (a draw lying within
    4 ulps of a CDF step may take the next bin: none at this n), vy and vz
    within 1e-6 of the largest (log, sin, cos of two libraries)."""
    n = 50_000
    jgrid = JGridSpec(800, 1e-3, "dirichlet-neumann")
    key = jax.random.PRNGKey(5)
    ref = jsources.sample_flux_6d_hash(key, n, jgrid, TI, M_PROTON, vx=0.0,
                                       gamma=0.5, vx_pert=-3.0, components=True)
    u = np.asarray(jsources.hash_uniforms(jsources.seed_from_key(key), n, 8,
                                          jnp.float32))
    got = sources.flux_from_uniforms(_t(u), GridSpec(800, 1e-3, "dirichlet-neumann"),
                                     TI, M_PROTON, 0.0, 0.5, -3.0)
    cdf = sources.flux_table(TI, M_PROTON, 0.0).cdf
    near = np.abs(u[5][:, None] - cdf[None, :]).min(axis=1) <= 4 * 2.0**-24
    assert near.sum() == 0
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(ref["x"]))
    np.testing.assert_array_equal(got["vx"].numpy(), np.asarray(ref["vx"]))
    for k in ("vy", "vz"):
        _close(ref[k], got[k], 1e-6)


def test_flux_draw_layout_moments_and_counters():
    """The flux draw's uniforms are philox4x32_plain's words at counters
    (slot, step, block, FLUX_TAG); its moments match sample_flux_6d's
    (threefry) at n = 200,000 (x, vy and vz mean and spread, v_x's mean,
    spread and the beam's share within 2%); its counters are neither the
    source batch's nor the gyro-phases'."""
    key, step, n = (3, 9), 4, 200_000
    u = cuda_rng.philox_uniforms(key, step, n, 8, cuda_rng.FLUX_TAG, device="cpu")
    idx = torch.arange(n, dtype=torch.int64)
    words = (cuda_rng.philox4x32_plain(key, (idx, step, 0, cuda_rng.FLUX_TAG))
             + cuda_rng.philox4x32_plain(key, (idx, step, 1, cuda_rng.FLUX_TAG)))
    assert torch.equal(u, cuda_rng.uniforms_from_bits(torch.stack(words)))
    src = cuda_rng.source_uniforms(key, step, n, device="cpu")
    gyro = cuda_rng.philox_uniforms(key, step, n, 3, cuda_rng.GYRO_TAG, device="cpu")
    assert not torch.equal(u[:4], src) and not torch.equal(u[:3], gyro)
    assert not torch.equal(src[:3], gyro)

    grid = GridSpec(800, 1e-3, "dirichlet-neumann")
    got = sources.sample_flux_batch(key, step, n, grid, TI, M_PROTON, 0.0, 0.5,
                                    -3.0, device="cpu")
    ref = jsources.sample_flux_6d(jax.random.PRNGKey(1), n,
                                  JGridSpec(800, 1e-3, "dirichlet-neumann"),
                                  TI, M_PROTON, vx=0.0, gamma=0.5, vx_pert=-3.0,
                                  components=True)
    vth = float(np.sqrt(K_BOLTZMANN * TI / M_PROTON))
    for k in ("x", "vx", "vy", "vz"):
        a, b = got[k].double().numpy(), np.asarray(ref[k], np.float64)
        scale = grid.dx if k == "x" else vth
        assert abs(a.mean() - b.mean()) < 0.02 * scale, k
        assert abs(a.std() - b.std()) < 0.02 * scale, k
    beam = np.float32(-3.0 * vth)
    share = (got["vx"].numpy() == beam).mean()
    assert abs(share - (np.asarray(ref["vx"]) == beam).mean()) < 0.02


def test_compact_rows_matches_jax():
    mask = np.random.default_rng(4).uniform(size=1000) < 0.3
    got = compact_rows(_t(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcompact_rows(jnp.asarray(mask))))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# the preset's own grid (dx = LD / 2): on grids coarser than the Debye
# length (ng <= 200 here) the reference's D-N Newton stops at maxiter and
# phi runs away in both packages
N_STEP, NG_STEP = 4000, 800
STEP_AT = (0, 10, 50)


def _tcfg_of(jcfg, **kw):
    return dc.replace(magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source")},
        grid=GridSpec(jcfg.grid.ng, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(jcfg.source))), **kw)


def _replay(jcfg, keys):
    """source_draws replaying the JAX flux draws of the steps whose keys
    are ``keys`` (step -> the JAX state's key at that step)."""
    src = jcfg.source

    def source_draws(step, n):
        _, _, k_src, _ = jax.random.split(keys[step], 4)
        batch = jsources.sample_flux_6d(
            k_src, n, jcfg.grid, src.ti, src.mass, vx=src.vx,
            gamma=jcfg.flux_gamma, vx_pert=jcfg.flux_vx_pert, components=True)
        return {k: _t(v) for k, v in batch.items()}
    return source_draws


@pytest.fixture(scope="module")
def dn_states():
    """dirichlet_neumann_test(n=4000, ng=800) in JAX: the states after
    0, 10 and 50 steps."""
    pre = jpresets.dirichlet_neumann_test(n=N_STEP, ng=NG_STEP)
    step = jax.jit(jmag.make_step(pre.config))
    states, st = {}, pre.state
    for i in range(max(STEP_AT) + 1):
        if i in STEP_AT:
            states[i] = st
        st, _ = step(st)
    return pre.config, states


def _assert_step_close(js, jm, ts, tm):
    """tests/test_magnetized.py:461-489's limits: n (the D-N solve's
    density, in rho's place) rtol 1e-4, phi rtol 1e-3 (atol 1e-8), active
    positions rtol 2e-5 (atol 1e-5), velocities rtol 2e-4 (atol 1), equal
    counts."""
    np.testing.assert_allclose(tm.rho.numpy(), np.asarray(jm.rho), rtol=1e-4)
    np.testing.assert_allclose(tm.phi.numpy(), np.asarray(jm.phi), rtol=1e-3,
                               atol=1e-8)
    act = np.asarray(js.active) == 1
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    np.testing.assert_allclose(ts.p.numpy()[act], np.asarray(js.p)[act],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy()[act], np.asarray(js.v)[act],
                               rtol=2e-4, atol=1.0)
    assert int(tm.n_reactivated) == int(jm.n_reactivated)
    assert int(tm.n_hit_wall) == int(jm.n_hit_wall)
    np.testing.assert_allclose(float(tm.n0), float(jm.n0), rtol=1e-5)


@pytest.mark.parametrize("at", STEP_AT)
@pytest.mark.parametrize("newton", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_dn_engine_step_matches_jax(dn_states, backend, newton, at):
    """One D-N step from JAX's state after ``at`` steps, the same backend
    and Newton route on each side (Thomas, or the kernel's plain PCR
    against Pallas interpret), the JAX flux draws replayed: the limits
    above, equal Newton counts, re-activations capped at flux_limit."""
    jcfg0, states = dn_states
    jcfg = dc.replace(jcfg0, backend=backend, newton_backend=newton)
    jst = states[at]
    js, jm = jmag.make_step(jcfg)(jst)
    d = {k: np.asarray(getattr(jst, k)) for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    ts = interop.magnetized_state_from_numpy(d, "cpu")
    tstep = magnetized.make_step(_tcfg_of(jcfg),
                                 source_draws=_replay(jcfg, {at: jst.rng}))
    ts1, tm = tstep(ts)
    _assert_step_close(js, jm, ts1, tm)
    assert int(tm.newton_iters) == int(jm.newton_iters)
    assert 0 < int(tm.n_reactivated) <= jcfg.flux_limit or at == 0


def test_dn_engine_25_steps_match_jax():
    """ROADMAP 14b step 1's 25-cycle test: 25 steps of the preset at
    n = 4000, ng = 800 in both packages, the Thomas route on both sides
    (JAX's 'auto' on the CPU; the D-N Newton stops at tol 1e-3, so two
    solvers would part by that much a step and the trajectories with
    them), the JAX flux draws replayed each step: equal wall losses,
    re-activations and active counts every step, phi within 2e-3 of its
    largest (each solve stops at ||dphi|| <= 1e-3 V, 6e-5 of max|phi|, and
    25 steps of trajectories carry it; measured 1.4e-3) and n0 within
    1e-4 at every step. The gather is the continuous CIC one: the
    reference's mirrored weights jump at cell faces, so a position one ulp
    either side of a face takes another field (a 6 km/s kick at step 3
    here) and the two runs part by chance, not by fault."""
    jpre = jpresets.dirichlet_neumann_test(n=N_STEP, ng=NG_STEP)
    jcfg = dc.replace(jpre.config, gather_weights="cic")
    step = jax.jit(jmag.make_step(jcfg))
    keys, jms, st = {}, [], jpre.state
    for i in range(25):
        keys[i] = st.rng
        st, m = step(st)
        jms.append(m)
    tpre = presets.dirichlet_neumann_test(n=N_STEP, ng=NG_STEP, device="cpu")
    tcfg = dc.replace(tpre.config, newton_backend="xla", gather_weights="cic")
    fin, tm = run(magnetized.make_step(tcfg, source_draws=_replay(jcfg, keys)),
                  tpre.state, 25)
    jphi = np.stack([np.asarray(m.phi) for m in jms])
    _close(jphi, tm.phi.numpy(), 2e-3)
    for k in ("n_hit_wall", "n_reactivated", "n_active"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.array([int(getattr(m, k)) for m in jms]), k)
    np.testing.assert_allclose(tm.n0.numpy(), [float(m.n0) for m in jms], rtol=1e-4)
    assert int(tm.n_reactivated.sum()) > 0


@pytest.mark.slow  # ~15 s on the CPU: 600 steps at n = 20,000
def test_dirichlet_neumann_flux_equilibrium():
    """tests/test_magnetized.py:379-415 on the port's own Philox flux
    draw: the adaptive n0 equilibrates, phi sits at 0 at the Dirichlet
    wall and above 5 V at the far end, the flux cap holds."""
    from pypic_tpu_torch.tools import magnetized as row

    density, n, ng = 1e19, 20_000, 400
    te = 10.0 * EV_TO_K
    from pypic_tpu_torch.constants import E_CHARGE, EPSILON_0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(ng, 400.0 * debye, "dirichlet-neumann")
    p2c = density * grid.length / n
    rng = np.random.default_rng(2)
    x = rng.uniform(0, grid.length, n)
    vth = np.sqrt(K_BOLTZMANN * te / M_PROTON)
    v = rng.normal(0, vth, (n, 3))
    v[:, 0] = -np.abs(v[:, 0])
    src = magnetized.SourceSpec(mass=M_PROTON, charge_state=1.0, p2c=p2c,
                                species_idx=0, ti=te)
    cfg = magnetized.MagnetizedConfig(
        grid, 2e-10, te, b=(0.0, 0.0, 0.0), species_z=(1,), reactivate="flux",
        source=src, flux_limit=100, flux_gamma=0.5, flux_vx_pert=-3.0,
        newton_backend="pallas")
    st = magnetized.init_state(x, v, M_PROTON, 1.0, p2c, 0, cfg, seed=5,
                               device="cpu")
    fin, m = run(magnetized.make_step(cfg), st, 600)
    assert row.check_dn_row(cfg, fin, m) == []


@pytest.fixture(scope="module")
def io_size_pair():
    """dirichlet_neumann_test at tests/test_io.py's size (n = 2000,
    ng = 100) in both packages."""
    return (jpresets.dirichlet_neumann_test(n=2000, ng=100),
            presets.dirichlet_neumann_test(n=2000, ng=100, device="cpu"))


def test_dn_preset_state_and_interop_round_trip(io_size_pair):
    """The same numpy draws: the initial states are identical, the Philox
    key is the JAX key data, and a state carried across packages comes
    back bit-exact."""
    jpre, tpre = io_size_pair
    assert tpre.name == "dirichlet_neumann_test"
    assert presets.get("dirichlet_neumann_test", n=2000, ng=100,
                       device="cpu").config == tpre.config
    got = interop.magnetized_state_to_numpy(tpre.state)
    for k in interop._MAGNETIZED_FIELDS:
        ref = np.asarray(getattr(jpre.state, k))
        assert got[k].dtype == ref.dtype, k
        np.testing.assert_array_equal(got[k], ref, err_msg=k)
    np.testing.assert_array_equal(got["rng"], np.asarray(jpre.state.rng))
    back = interop.magnetized_state_to_numpy(
        interop.magnetized_state_from_numpy(got, "cpu"))
    for k in got:
        np.testing.assert_array_equal(back[k], got[k], err_msg=k)
    for f in ("flux_limit", "flux_gamma", "flux_vx_pert", "reactivate", "b"):
        assert getattr(tpre.config, f) == getattr(jpre.config, f)


def test_dn_preset_steps_at_the_io_size(io_size_pair):
    """The preset at tests/test_io.py's size steps on the port's own
    draws (the D-N kernel's plain version and the plain flux draw on the
    CPU): finite, the flux cap held, wall losses refilled from the flux.
    (At dx = 4 LD the reference's Newton soon stops at maxiter in both
    packages, so only a few steps.)"""
    _, tpre = io_size_pair
    cfg = dc.replace(tpre.config, newton_backend="pallas")
    fin, m = run(magnetized.make_step(cfg), tpre.state, 5)
    assert torch.isfinite(m.phi).all() and torch.isfinite(fin.p).all()
    assert int(m.n_reactivated.max()) <= cfg.flux_limit
    assert int(m.n_reactivated.sum()) > 0 and fin.step_host == 5
    # every slot inactive at a step's start is re-activated, up to the cap
    # ('reference' timing): the losses of step s come back at step s + 1
    np.testing.assert_array_equal(
        m.n_reactivated.numpy()[1:],
        np.minimum(m.n_hit_wall.numpy()[:-1], cfg.flux_limit))


def test_dn_row_tool_runs_on_the_cpu():
    """tools/magnetized.run_row(row='dn') drives the D-N row's path (the
    plain versions, a few steps at a small n); no kernel launches on the
    CPU, and the checks a short run can meet hold."""
    from pypic_tpu_torch.tools import magnetized as row

    res, cfg, fin, m = row.run_row("cpu", steps=6, warmup=1, row="dn", n=3000)
    assert res["n"] == 3000 and res["ng"] == 800 and res["launches"] == {}
    assert res["row"] == "dn" and res["newton_mean"] >= 1.0
    problems = row.check_dn_row(cfg, fin, m)
    assert not [p for p in problems if "Dirichlet wall" not in p
                and "Neumann end" not in p], problems
    assert fin.step_host == 6
