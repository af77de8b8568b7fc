"""The bounded two-species sheath slice of pypic_tpu_torch against
pypic_tpu.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode, as tests/test_pallas.py runs them) and the port's
counterpart (its plain kernel versions: the tensors lie on the CPU). Each
tolerance is stated beside its test. The engine step runs from one JAX
state in both packages, the JAX re-injection draws replayed in the port
through ``make_step(reinject_draws=...)``: jax.random streams cannot be
reproduced in PyTorch.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu.constants import E_CHARGE, K_BOLTZMANN, M_ELECTRON, M_PROTON
from pypic_tpu.engines import sheath as jsheath
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.ops import fd as jfd
from pypic_tpu.ops.pallas_cic import (_DEFAULT_BLOCK, sheath_finalize_pallas,
                                      sheath_picard_pallas)
from pypic_tpu.ops.pallas_rng import sheath_reinject_pallas
from pypic_tpu.presets import sheath_dd as jsheath_dd

from pypic_tpu_torch import diagnostics, initialize, interop, presets, sources
from pypic_tpu_torch.engines import sheath
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, cuda_rng, cuda_sheath, fd
from pypic_tpu_torch.runner import run

DT, DX = 1e-12, 1e-5
TE = 10.0 * 11600.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# loader and grid operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("perturbation", [0.0, 0.1])
def test_initialize_sheath_matches_jax(perturbation):
    """The same np.random.default_rng calls in the same order: every host
    array bit-equal, and the same derived parameters."""
    n, ng = 5001, 51
    grid = (JGridSpec(ng, DX * (ng - 1), "dirichlet-dirichlet"),
            GridSpec(ng, DX * (ng - 1), "dirichlet-dirichlet"))
    ref = jinit.initialize_sheath(n, 1e19, 1.0, perturbation, grid[0], TE, TE,
                                  seed=3)
    got = initialize.initialize_sheath(n, 1e19, 1.0, perturbation, grid[1],
                                       TE, TE, seed=3)
    for k in ("x", "v", "m", "q", "species"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert dc.asdict(got["params"]) == dc.asdict(ref["params"])


def test_integrate_neg_trapz_matches_jax():
    """The same float32 cumsum and operations (1e-6 of the largest)."""
    f = (np.random.default_rng(4).normal(size=51) * 2e4).astype(np.float32)
    ref = jfd.integrate_neg_trapz(jnp.asarray(f), DX)
    got = fd.integrate_neg_trapz(_t(f), DX)
    assert got.dtype == torch.float32
    assert _rel(ref, got) <= 1e-6


# ---------------------------------------------------------------------------
# the sheath Picard pass and finalize
# ---------------------------------------------------------------------------


def _pass_inputs(ng, n=20_000, seed=5):
    """Rows inside the grid, exactly at 0 and at cells, pre-lost left and
    right, and rows fast enough to cross a wall in the pass; two species'
    q/m and weights."""
    rng = np.random.default_rng(seed)
    cells = float(ng - 1)
    p0 = rng.uniform(0.0, cells, n).astype(np.float32)
    ps = np.clip(p0 + rng.normal(0, 0.2, n), -0.5, cells + 0.5).astype(np.float32)
    ion = rng.uniform(size=n) < 0.5
    qm = np.where(ion, E_CHARGE / M_PROTON, -E_CHARGE / M_ELECTRON).astype(np.float32)
    u0 = np.where(ion, rng.normal(0, 3e4, n), rng.normal(0, 1.3e6, n)).astype(np.float32)
    w = (np.where(ion, E_CHARGE, -E_CHARGE) * 1e9).astype(np.float32)
    act = np.ones(n, np.float32)
    p0[:4] = [0.0, cells, 0.0, cells]
    ps[:4] = p0[:4]
    act[4:40:2] = 0.0  # lost right in an earlier pass
    act[5:40:2] = -1.0  # lost left in an earlier pass
    # crossing: near a wall and heading out at several cells a step
    p0[40:60] = np.float32(0.3)
    u0[40:60] = np.float32(-2.5 * DX / DT)
    p0[60:80] = np.float32(cells - 0.3)
    u0[60:80] = np.float32(2.5 * DX / DT)
    es = (rng.normal(size=ng) * 2e4).astype(np.float32)
    return es, ps, p0, u0, qm, w, act


@pytest.mark.parametrize("ng", [51, 11])
def test_sheath_picard_plain_matches_pallas(ng):
    """sheath_picard's plain version against sheath_picard_pallas in
    interpret mode: the statuses equal; xh within 1e-6 cells (the TPU
    kernel gathers through tent windows, whose weights round otherwise);
    jh within 2e-5 of its largest node (float32 sums in two orders)."""
    es, ps, p0, u0, qm, w, act = _pass_inputs(ng)
    ref = sheath_picard_pallas(*(jnp.asarray(a) for a in (es, ps, p0, u0, qm, w, act)),
                               dt=DT, dx=DX, wall_ratio=DX * DX / DT)
    got = cuda_sheath.sheath_picard(*(_t(a) for a in (es, ps, p0, u0, qm, w, act)),
                                    dt=DT, dx=DX)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert (got[1].numpy()[40:80] != 1.0).all()  # the crossing rows left
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6 * ng)
    assert _rel(ref[2], got[2]) <= 2e-5


@pytest.mark.parametrize("ng", [51, 11])
def test_sheath_finalize_plain_matches_pallas(ng):
    """sheath_finalize's plain version against sheath_finalize_pallas in
    interpret mode: statuses equal, x1 within 1e-6 cells, u1 within 1e-6 of
    the largest, j1 within 2e-5 of its largest node; the plain finalize's
    status and the pass's agree."""
    es, ps, p0, u0, qm, w, act = _pass_inputs(ng, seed=6)
    args = [jnp.asarray(a) for a in (es, ps, p0, u0, qm, w, act)]
    ref = sheath_finalize_pallas(*args, dt=DT, dx=DX, wall_ratio=DX * DX / DT)
    targs = [_t(a) for a in (es, ps, p0, u0, qm, w, act)]
    got = cuda_sheath.sheath_finalize(*targs, dt=DT, dx=DX)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6 * ng)
    assert _rel(ref[1], got[1]) <= 1e-6
    assert _rel(ref[3], got[3]) <= 2e-5
    assert torch.equal(got[2], cuda_sheath.sheath_picard(*targs, dt=DT, dx=DX)[1])


def test_sheath_deposit_folds_wall_charge():
    """Every non-active row deposits its wall charge at its wall node: the
    node totals of a pass over lost rows alone are the exact sums."""
    ng = 11
    es, ps, p0, u0, qm, w, act = _pass_inputs(ng, n=400)
    act[:] = np.where(np.arange(400) % 2 == 0, 0.0, -1.0)
    _, _, jh = cuda_sheath.sheath_picard(*(_t(a) for a in (es, ps, p0, u0, qm, w, act)),
                                         dt=DT, dx=DX)
    ratio = cuda_sheath.sheath_scalars(DT, DX)[3]
    w64 = w.astype(np.float64)
    np.testing.assert_allclose(jh[0].item(), ratio * w64[act == -1].sum(), rtol=1e-6)
    np.testing.assert_allclose(jh[-1].item(), -ratio * w64[act == 0].sum(), rtol=1e-6)
    assert (jh[1:-1] == 0).all()


# ---------------------------------------------------------------------------
# thermostat + re-injection
# ---------------------------------------------------------------------------


def _reinject_inputs(n, seed=8):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 50, n).astype(np.float32)
    v = rng.normal(0, 1e5, (3, n)).astype(np.float32)
    act = rng.choice(np.asarray([1.0, 0.0, -1.0], np.float32), n, p=[0.8, 0.1, 0.1])
    m = np.where(rng.uniform(size=n) < 0.5, M_ELECTRON, M_PROTON).astype(np.float32)
    sig = np.sqrt(np.float32(K_BOLTZMANN * TE) / m).astype(np.float32)
    sigth = np.sqrt(np.float32(K_BOLTZMANN * TE * 0.5) / m).astype(np.float32)
    return p, v[0], v[1], v[2], act, sig, sigth


@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_reinject_transform_matches_pallas(gamma):
    """The transform alone on the bits the JAX kernel draws in interpret
    mode (jax.random.bits(key, (nb, ndraw, block)), row = b block + t):
    positions exact; log, sin and cos of two libraries put the normals a
    few float32 ulps apart (1e-6 of the largest); rows neither lost nor
    resampled keep their inputs bit for bit."""
    n, cells = 20_000, 50.0
    arrs = _reinject_inputs(n)
    key = jax.random.PRNGKey(9)
    ref = sheath_reinject_pallas(jnp.uint32(0), key, *(jnp.asarray(a) for a in arrs),
                                 cells=cells, gamma=gamma)
    ndraw = cuda_rng.reinject_ndraw(gamma)
    nb = -(-n // _DEFAULT_BLOCK)
    bits = np.asarray(jax.random.bits(key, (nb, ndraw, _DEFAULT_BLOCK), jnp.uint32))
    bits = bits.transpose(1, 0, 2).reshape(ndraw, -1)[:, :n].astype(np.int64)
    got = cuda_rng.sheath_reinject_from_bits_plain(
        torch.from_numpy(bits), *(_t(a) for a in arrs), cells=cells, gamma=gamma)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for r, g in zip(ref[1:], got[1:]):
        assert _rel(r, g) <= 1e-6
    act = arrs[4]
    uni = cuda_rng.uniforms_from_bits(torch.from_numpy(bits)).numpy()
    held = act == 1.0
    if gamma > 0.0:
        held &= ~(uni[5] < np.float32(gamma))
        assert (~held & (act == 1.0)).sum() > 0.4 * (act == 1.0).sum()
    for g, a in zip(got, arrs[:4]):
        np.testing.assert_array_equal(g.numpy()[held], a[held])
    assert ((got[0].numpy() > 0) & (got[0].numpy() < cells)).all()


def test_reinject_philox_layout_and_moments():
    """A row's draws are its Philox words at counters (row, step, j, 0) in
    order; the re-injected positions fill [0, cells) uniformly and the
    velocities are Maxwellian at sig."""
    n = 100_000
    words = cuda_rng.reinject_bits_plain((3, 4), 11, n, 10)
    blk = cuda_rng.philox4x32_plain((3, 4), (torch.arange(n), 11, 2, 0))
    assert torch.equal(words[8], blk[0]) and torch.equal(words[9], blk[1])
    u = cuda_rng.sheath_uniforms((3, 4), 11, n, gamma=0.5, device="cpu")
    assert torch.equal(u, cuda_rng.uniforms_from_bits(words))
    ones = torch.ones(n)
    p, ux, uy, uz = cuda_rng.sheath_reinject(
        (3, 4), 11, ones, ones, ones, ones, torch.zeros(n), torch.full((n,), 2.0),
        cells=50.0)
    x = p.double().numpy()
    assert (x > 0).all() and (x < 50).all()
    assert abs(x.mean() - 25.0) < 0.2 and abs(x.std() - 50 / np.sqrt(12)) < 0.2
    for comp in (ux, uy, uz):
        c = comp.double().numpy()
        assert abs(c.std() - 2.0) < 0.03 and abs(c.mean()) < 0.03


def test_plain_reinject_is_bit_reproducible():
    """The plain Box-Muller gives the same bits on a second call after
    unrelated tensor work (other allocations, another thread count,
    strided views of the inputs): the CPU replays depend on it."""
    n = 20_003
    arrs = [_t(a) for a in _reinject_inputs(n, seed=12)]
    kw = dict(cells=50.0, gamma=0.25)
    a = cuda_rng.sheath_reinject_plain((0, 7), 5, *arrs, **kw)
    junk = [torch.randn(997 + 13 * i).sin_() for i in range(40)]
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    try:
        wide = [torch.stack([t, t], 1) for t in arrs]
        b = cuda_rng.sheath_reinject_plain((0, 7), 5, *(t[:, 1] for t in wide), **kw)
    finally:
        torch.set_num_threads(threads)
    c = cuda_rng.sheath_reinject_plain((0, 7), 5, *arrs, **kw)
    del junk
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

N_STEP = 6000
STEP_AT = (0, 10, 50)


def _tcfg_of(jcfg):
    return sheath.SheathConfig(
        **{f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
           if f.name != "grid"},
        grid=GridSpec(jcfg.grid.ng, jcfg.grid.length, jcfg.grid.bc))


def _replay(jstate, jcfg):
    """The JAX step's own draws (threefry, 'auto' on the CPU:
    engines/sheath.py:287-381) as the port's reinject_draws."""
    _, k_tu, k_tv, k_rx, k_rv = jax.random.split(jstate.rng, 5)
    n = jstate.p.shape[0]
    dtype = jstate.p.dtype
    cells = float(jcfg.grid.num_cells)

    def rows(z):
        return tuple(torch.from_numpy(np.array(z[i])) for i in range(3))

    d = {"x": _t(jax.random.uniform(k_rx, jstate.p.shape, dtype, 0.0, cells)),
         "z": rows(jax.random.normal(k_rv, (3, n), dtype))}
    if jcfg.gamma > 0.0:
        d["u_therm"] = _t(jax.random.uniform(k_tu, jstate.p.shape))
        d["z_therm"] = rows(jax.random.normal(k_tv, (3, n), dtype))

    def draws(step, n_draw):
        assert n_draw == n and step == int(jstate.step)
        return d
    return draws


@pytest.fixture(scope="module")
def step_cases():
    """sheath_dd(n=6000) with the row's Picard options, the exit
    histograms recording from step 0 and a thermostat; the JAX states
    after 0, 10 and 50 steps, and one JAX step from each with each
    backend."""
    pre = jsheath_dd(n=N_STEP, gamma=0.05)
    cfg = dc.replace(pre.config, record_exit_after_step=0,
                     picard_init="extrapolate", picard_accel="anderson")
    states, st = {}, pre.state
    step = jax.jit(jsheath.make_step(cfg))
    for i in range(max(STEP_AT) + 1):
        if i in STEP_AT:
            states[i] = st
        st, _ = step(st)
    out = {}
    for backend in ("composed", "fused"):
        jcfg = dc.replace(cfg, backend=backend)
        jstep = jax.jit(jsheath.make_step(jcfg))
        for i, s in states.items():
            out[backend, i] = (jcfg, s) + tuple(jstep(s))
    return out


@pytest.mark.parametrize("at", STEP_AT)
@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_engine_step_matches_jax(step_cases, backend, at):
    """One step from the JAX state after ``at`` steps, the same backend on
    each side and the JAX draws replayed: equal Picard counts (or one pass
    apart where the first to stop left by the float32 floor exit: summation
    order decides it, diagnostics.floor_exit_counts_agree), wall losses
    and statuses; active positions within 1e-5 cells, u within 1e-6 of
    the largest, e, j and phi within 1e-5 of their largest (float32 sums
    in other orders), the exit histograms equal."""
    jcfg, jst, js1, jm = step_cases[backend, at]
    d = {k: np.asarray(getattr(jst, k)) for k in interop._SHEATH_FIELDS + ("rng",)}
    tst = interop.sheath_state_from_numpy(d, "cpu")
    ts1, tm = sheath.make_step(_tcfg_of(jcfg), reinject_draws=_replay(jst, jcfg))(tst)
    ok, line = diagnostics.floor_exit_counts_agree(
        jm.picard_iters, jm.picard_residual, tm.picard_iters,
        tm.picard_residual, jst.e, js1.e, tol=jcfg.tol,
        tol_floor=jcfg.tol_floor)
    assert ok, line
    assert int(tm.n_lost_left) == int(jm.n_lost_left)
    assert int(tm.n_lost_right) == int(jm.n_lost_right)
    assert int(tm.n_active) == int(jm.n_active)
    np.testing.assert_array_equal(ts1.active.numpy(), np.asarray(js1.active))
    act = np.asarray(js1.active) == 1
    np.testing.assert_allclose(ts1.p.numpy()[act], np.asarray(js1.p)[act],
                               rtol=0, atol=1e-5)
    for k in ("u", "vy", "vz"):
        assert _rel(np.asarray(getattr(js1, k)), getattr(ts1, k)) <= 1e-6, k
    for k in ("e", "j"):
        assert _rel(np.asarray(getattr(js1, k)), getattr(ts1, k)) <= 1e-5, k
    assert _rel(jm.phi, tm.phi) <= 1e-5
    np.testing.assert_array_equal(ts1.exit_hist.numpy(), np.asarray(js1.exit_hist))
    for k in ("field_energy", "kinetic_energy", "current_bias"):
        np.testing.assert_allclose(float(getattr(tm, k)), float(getattr(jm, k)),
                                   rtol=1e-4, err_msg=k)
    assert ts1.step_host == at + 1


def test_step_cases_lose_and_record(step_cases):
    """The cases exercise what they compare: wall losses on both walls,
    recorded exits and a non-trivial Picard loop."""
    lost = sum(int(c[3].n_lost_left) + int(c[3].n_lost_right)
               for c in step_cases.values())
    assert lost > 0
    assert float(np.asarray(step_cases["fused", 50][2].exit_hist).sum()) > 0
    assert all(int(c[3].picard_iters) >= 2 for c in step_cases.values())


@pytest.mark.parametrize("case", ["equal", "floor", "below_tol", "two_apart",
                                  "above_floor"])
def test_floor_exit_counts_agree(case):
    """A one-pass gap is admitted only where the first run to stop left by
    the floor exit: tol < r <= tol_floor eps ||eh|| (||eh|| = 2e4 here,
    threshold 1.19e-3)."""
    e0 = np.full(4, 1e4)
    e1 = e0.copy()
    k_a, r_a, k_b = {"equal": (4, 1.0, 4), "floor": (3, 1.0e-3, 4),
                     "below_tol": (3, 1e-6, 4), "two_apart": (3, 1.0e-3, 5),
                     "above_floor": (3, 2.0e-3, 4)}[case]
    ok, line = diagnostics.floor_exit_counts_agree(
        k_a, r_a, k_b, 5e-4, e0, e1, tol=1e-5, tol_floor=0.5)
    assert ok == (case in ("equal", "floor")), line


def _setup(n=4000, gamma=0.0, **kw):
    """tests/test_sheath.py:21-38 on the port: the reference configuration
    at a small n, loaded with seed 3, keyed with seed 1."""
    ng = 51
    grid = GridSpec(ng, DX * (ng - 1), "dirichlet-dirichlet")
    d = initialize.initialize_sheath(n, 1e19, 1.0, 0.0, grid, TE, TE, seed=3)
    cfg = sheath.SheathConfig(
        grid, DT, grid.length * 1e19 / n, kbte=K_BOLTZMANN * TE,
        kbti=K_BOLTZMANN * TE, gamma=gamma, exit_hist_vmax=3e6,
        record_exit_after_step=300, **kw)
    st = sheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg,
                           seed=1, device="cpu")
    return cfg, st


def test_sheath_picard_telemetry_and_counts():
    """tests/test_sheath.py:60-69 (fused, its plain versions), 150 steps:
    Picard counts within maxiter, most rows active, and every row lost in
    a step re-injected at the next step's start."""
    cfg, st = _setup(backend="fused")
    _, m = run(sheath.make_step(cfg), st, 150)
    assert int(m.picard_iters.max()) <= cfg.maxiter
    n_act = m.n_active.numpy()
    assert (n_act <= 4000).all() and (n_act > 3000).all()
    lost = m.n_lost_left.numpy() + m.n_lost_right.numpy()
    assert (n_act + lost == 4000).all()
    assert lost.sum() > 0


def test_thermostat_resamples_to_ion_temperature():
    """tests/test_sheath.py:81-96: gamma = 1 resamples every active row's
    velocity to the ion temperature (the transverse components are not
    pushed, so their spread is the thermostat's), through the port's
    Philox sampler."""
    cfg, st = _setup(n=20_000, gamma=1.0, backend="fused")
    st = st.replace(u=st.u * 5.0, vy=st.vy * 5.0, vz=st.vz * 5.0)
    fin, _ = run(sheath.make_step(cfg), st, 1)
    v = fin.v.numpy()
    act = fin.active.numpy() == 1
    for sp, mass in ((1, M_ELECTRON), (2, M_PROTON)):
        sel = act & (fin.species.numpy() == sp)
        vth = np.sqrt(K_BOLTZMANN * TE / mass)
        std = v[sel, 1].std()
        assert 0.9 * vth < std < 1.1 * vth, (sp, std, vth)


@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_wall_charge_current_terms(backend):
    """tests/test_sheath.py:134-158: an ion crossing the left wall in one
    step deposits the wall surface-charge current dx q p2c / dt at node 0
    (folded with j[1])."""
    ng, p2c = 11, 1e10
    grid = GridSpec(ng, DX * (ng - 1), "dirichlet-dirichlet")
    cfg = sheath.SheathConfig(grid, DT, p2c, kbte=1e-19, kbti=1e-19, tol=1e30,
                              maxiter=1, backend=backend)
    st = sheath.init_state(np.asarray([0.5 * DX]), np.asarray([[-1e7, 0.0, 0.0]]),
                           np.asarray([E_CHARGE]), np.asarray([M_PROTON]),
                           np.asarray([2]), cfg, seed=0, device="cpu")
    fin, met = run(sheath.make_step(cfg), st, 1)
    assert int(met.n_lost_left[0]) == 1
    j = fin.j.numpy()
    assert j[0] != 0.0
    np.testing.assert_allclose(j[0], DX * E_CHARGE * p2c / DT, rtol=1e-5)


@pytest.mark.slow
def test_sheath_floor_exit_and_anderson_fewer_iters_same_sheath():
    """tests/test_sheath.py:161-188 on the port (fused, plain versions):
    without the float32 floor exit the loop grinds round-off; with it
    (default) it exits in a handful of passes at the same sheath, and
    Anderson + extrapolation is no worse."""
    cfg, st = _setup(n=8000, backend="fused")
    runs = {}
    for name, c in (("grind", dc.replace(cfg, tol_floor=0.0)), ("base", cfg),
                    ("anderson", dc.replace(cfg, picard_init="extrapolate",
                                            picard_accel="anderson"))):
        _, runs[name] = run(sheath.make_step(c), st, 400)
    it = {k: m.picard_iters[-200:].double().mean().item() for k, m in runs.items()}
    assert it["base"] < it["grind"] - 2.0, it
    assert it["anderson"] <= it["base"] + 0.5, it
    phi = {k: m.phi[-100:].double().mean(0).numpy() for k, m in runs.items()}
    scale = np.abs(phi["grind"]).max()
    for k in ("base", "anderson"):
        np.testing.assert_allclose(phi[k], phi["grind"], atol=0.05 * scale)


@pytest.mark.slow
def test_sheath_tol_floor_uses_working_dtype():
    """tests/test_sheath.py:269-282 on the port: a float64 state (CPU, the
    plain gather and deposit) reaches the reference's absolute tol once the
    field develops; the floor uses float64's eps."""
    cfg, st = _setup()
    st64 = st.replace(**{k: getattr(st, k).double() for k in
                         ("p", "u", "vy", "vz", "q", "m", "e", "j", "e_prev",
                          "exit_hist")})
    _, m = run(sheath.make_step(cfg), st64, 300)
    r = m.picard_residual.numpy()
    assert m.picard_residual.dtype == torch.float64
    assert (r[-100:] <= cfg.tol).all(), r[-100:].max()


def test_float64_step_floor_recedes():
    """A float64 step on the CPU runs, and its floor exit uses float64's
    eps: at the reference tol the float64 loop takes more passes than the
    float32 loop from the same state once the field is sheath-sized."""
    cfg, st = _setup(n=2000, backend="composed")
    st, _ = run(sheath.make_step(cfg), st, 30)
    st64 = st.replace(**{k: getattr(st, k).double() for k in
                         ("p", "u", "vy", "vz", "q", "m", "e", "j", "e_prev",
                          "exit_hist")})
    _, m32 = sheath.make_step(cfg)(st)
    s64, m64 = sheath.make_step(cfg)(st64)
    assert s64.p.dtype == torch.float64 and m64.phi.dtype == torch.float64
    assert int(m64.picard_iters) > int(m32.picard_iters)
    assert float(m64.picard_residual) <= cfg.tol or int(m64.picard_iters) == cfg.maxiter


# ---------------------------------------------------------------------------
# configuration, interop, presets, the row tool
# ---------------------------------------------------------------------------


def _cfg_kw(grid):
    return dict(grid=grid, dt=DT, p2c=1e10, kbte=1e-18, kbti=1e-18)


@pytest.mark.parametrize("kw, match", [
    (dict(picard_init="bogus"), "picard_init"),
    (dict(picard_accel="bogus"), "picard_accel"),
    (dict(rng_sampler="bogus"), "rng_sampler"),
    (dict(axis_name="p", rng_sampler="pallas"), "pallas"),
    (dict(axis_name="p", rng_sampler="threefry"), "shard-invariant"),
])
def test_config_value_errors(kw, match):
    """The JAX config's ValueErrors, raised by the port's as well."""
    for mod, grid in ((jsheath, JGridSpec(11, 1e-4, "dirichlet-dirichlet")),
                      (sheath, GridSpec(11, 1e-4, "dirichlet-dirichlet"))):
        with pytest.raises(ValueError, match=match):
            mod.SheathConfig(**_cfg_kw(grid), **kw)


@pytest.mark.parametrize("kw", [dict(axis_name="p", rng_sampler="hash"),
                                dict(rng_sampler="hash")],
                         ids=["axis_name", "hash"])
def test_hash_sampler_runs(kw):
    """The 'hash' sampler (and under axis_name on one rank): the lost rows
    re-inject at the hash uniforms' positions (tests/test_torch_
    dataparallel.py holds the engine to JAX's hash runs)."""
    cfg, st = _setup(n=256, gamma=0.5, **kw)
    act = st.active.clone()
    act[:16] = 0  # lost rows re-inject
    st1, m = sheath.make_step(cfg)(st.replace(active=act))
    seed = sources.step_seed(st.rng, 0, sheath.HASH_STREAMS.index("reinj_x"))
    x = sources.hash_uniforms(seed, 256, 1, device="cpu")[0]
    x0 = (x * np.float32(cfg.grid.num_cells))[:16]
    assert np.isfinite(m.phi.numpy()).all()
    # the re-injected rows start from the drawn positions (then move)
    assert (np.abs(st1.p[:16].numpy() - x0.numpy()) < 0.5).mean() > 0.5


def test_unknown_backend_raises_at_the_step():
    cfg, st = _setup(n=64, backend="bogus")
    with pytest.raises(ValueError, match="backend"):
        sheath.make_step(cfg)(st)


@pytest.mark.parametrize("kw, item", [
    (dict(rng_sampler="threefry"), "jax.random"),
])
def test_unported_options_raise(kw, item):
    cfg = sheath.SheathConfig(**_cfg_kw(GridSpec(11, 1e-4, "dirichlet-dirichlet")),
                              **kw)
    with pytest.raises(NotImplementedError, match=item):
        sheath.make_step(cfg)
    with pytest.raises(NotImplementedError, match=item):
        sheath.init_state(np.full(4, 1e-5), np.zeros((4, 3)), np.ones(4),
                          np.ones(4), np.ones(4, np.int32), cfg, device="cpu")


def test_float64_on_the_card_names_its_item():
    """The sheath engine has double kernels (ROADMAP item 19a): its
    dispatch takes a float64 state on the card as on the CPU, refuses
    float16 with a TypeError; the magnetized and explicit engines take
    one too (items 19b, 19c)."""
    cfg = sheath.SheathConfig(**_cfg_kw(GridSpec(11, 1e-4, "dirichlet-dirichlet")))
    cuda = torch.device("cuda", 0)
    cuda_cic.check_engine_dtype("sheath", cuda, torch.float64)
    cuda_cic.check_engine_dtype("sheath", torch.device("cpu"), torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_cic.check_engine_dtype("sheath", cuda, torch.float16)
    cuda_cic.check_engine_dtype("magnetized", cuda, torch.float64)
    cuda_cic.check_engine_dtype("explicit", cuda, torch.float64)
    with pytest.raises(TypeError, match="float32 or float64"):
        cuda_cic.check_engine_dtype("explicit", cuda, torch.float16)
    assert cfg.rng_sampler == "auto"


def test_preset_and_interop_round_trip():
    """sheath_dd builds the JAX preset's state bit for bit (the port's key
    is the JAX key data), and a JAX state round-trips bit-exactly."""
    jpre = jsheath_dd(n=1000, seed=2)
    tpre = presets.get("sheath_dd", n=1000, seed=2, device="cpu")
    assert tpre.name == "sheath_dd" and tpre.config.exit_hist_vmax == 3e6
    d = {k: np.asarray(getattr(jpre.state, k)) for k in
         interop._SHEATH_FIELDS + ("rng",)}
    got = interop.sheath_state_to_numpy(tpre.state)
    assert set(got) == set(d)
    for k in d:
        assert got[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(got[k], d[k], err_msg=k)
    back = interop.sheath_state_to_numpy(interop.sheath_state_from_numpy(d, "cpu"))
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    st = interop.sheath_state_from_numpy(d, "cpu")
    assert st.step_host == 0 and st.rng == (0, 2)
    assert sorted(presets.PRESETS) == ["bump_on_tail", "dirichlet_neumann_test",
                                       "domain_explicit", "domain_implicit",
                                       "explicit_landau", "landau_damping",
                                       "pic_bca_aps", "pic_iead", "pic_iead_dd",
                                       "pic_iead_gc", "sheath_dd", "two_stream"]
    with pytest.raises(KeyError):
        presets.get("nope")


def test_row_tool_runs_on_the_cpu():
    """tools/sheath.run_row drives the configs[2] row's path (here the
    plain versions, fused, a few steps at a small n): no kernel launch on
    the CPU, the population kept, the Picard counts within maxiter."""
    from pypic_tpu_torch.tools import sheath as row

    res, cfg, fin, m = row.run_row("cpu", steps=6, n=3000, warmup=1,
                                   backend="fused")
    assert res["n"] == 3000 and res["steps"] == 6 and res["launches"] == {}
    assert res["device"] == "cpu" and 1.0 <= res["picard_mean"] <= cfg.maxiter
    problems = row.check_row(cfg, fin, m, last=3)
    assert not [p for p in problems if "potential's maximum" not in p
                and "wall at" not in p], problems
    assert fin.step_host == 6
    assert cuda_cic.LAUNCHES["sheath_picard"] == 0


def test_row_tool_replays_a_step():
    """tools/sheath.replay on the CPU at a small n: the residual history
    of each side ends where its loop stopped, the float32 sides agree bit
    for bit (here both run the plain versions), the float64 floor lies far
    below the float32 one."""
    from pypic_tpu_torch.tools import sheath as row

    res = row.replay(3, "cpu", n=3000)
    card, f32, f64 = res["card"], res["cpu_float32"], res["cpu_float64"]
    assert res["step"] == 3 and len(res["picard_iters_before"]) == 3
    assert card == f32
    for side in (card, f64):
        assert 1 <= side["passes"] <= 20
        assert len(side["residual"]) == side["passes"]
        assert side["at_maxiter"] == (side["passes"] == 20)
        assert len(side["floor"]) == len(side["residual"])
    assert f64["floor"][0] < 1e-6 * card["floor"][0]


@pytest.mark.parametrize("periodic", [False, True], ids=["bounded", "periodic"])
def test_deposit_det_on_the_cpu_is_the_plain_deposit(periodic):
    """On CPU tensors the deterministic deposit runs the plain deposit
    (bit-equal) and counts no launch, also at an ng whose 32 thread
    histograms overflow shared memory: that limit is the card's
    (tests/test_torch_cuda.py holds the raise there)."""
    rng = np.random.default_rng(6)
    p = _t(rng.uniform(0, 50, 4001).astype(np.float32))
    vals = _t(rng.normal(0, 1e3, 4001).astype(np.float32))
    before = cuda_cic.LAUNCHES["deposit_det"]
    got = cuda_cic.deposit_det(p, vals, 51, periodic=periodic)
    assert torch.equal(got, cuda_cic.deposit_plain(p, vals, 51, periodic=periodic))
    assert cuda_cic.LAUNCHES["deposit_det"] == before
    got = cuda_cic.deposit_det(p * 40, vals, 1817, periodic=periodic)
    assert torch.equal(got, cuda_cic.deposit_plain(p * 40, vals, 1817,
                                                   periodic=periodic))
    assert cuda_cic.LAUNCHES["deposit_det"] == before


# chip_smoke.py's limits on the card's sheath results: phase 16's wall
# nodes of a wall-charge-only pass within 2e-5 of the exact sums (TOL_DEP);
# phase 17, card against CPU, one step's j within 1e-5 of its largest node
# (TOL_SHEATH_STEP), the 200-step time-averaged phi within 1e-4 Te/e
# (TOL_SHEATH_PHI_AVG)
WALL_ONLY_LIMIT, STEP_J_LIMIT, PHI_AVG_LIMIT = 2e-5, 1e-5, 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("where", ["wall charge", "current"])
def test_sheath_checks_see_a_one_percent_fault(where):
    """A fault planted in the plain pass (the wall charge, or the whole
    deposited current, 1% too large) against chip_smoke.py's checks at
    their own settings, both sides on the CPU: phase 16's wall-charge-only
    pass (u0 = qm = 0: the wall nodes hold only the lost rows' charge)
    against the exact float64 sums, and phase 17's sheath_dd comparisons
    (n = 12,000, fused: one step from the initial state; 200 steps, phi
    averaged over the last 100). Prints the three readings; at least one
    exceeds its limit."""
    import dataclasses

    pre = presets.sheath_dd(n=12_000, device="cpu")
    cfg = dataclasses.replace(pre.config, record_exit_after_step=0,
                              picard_init="extrapolate", picard_accel="anderson",
                              backend="fused")
    d = interop.sheath_state_to_numpy(pre.state)
    te_volts = K_BOLTZMANN * TE / E_CHARGE
    name = "sheath_scalars" if where == "wall charge" else "sheath_deposit_plain"
    good = getattr(cuda_sheath, name)
    if where == "wall charge":
        def bad(dt, dx, *dtype):
            return (*good(dt, dx, *dtype)[:3], good(dt, dx, *dtype)[3] * 1.01)
    else:
        def bad(*args, **kw):
            return good(*args, **kw) * 1.01
    ng, n = 51, 4000
    rng = np.random.default_rng(12)
    p0 = _t(rng.uniform(0, ng - 1, n).astype(np.float32))
    w = _t(np.where(rng.uniform(size=n) < 0.5, 1.602e-10, -1.602e-10).astype(np.float32))
    act = _t(rng.choice(np.asarray([1.0, 0.0, -1.0], np.float32), n, p=[0.9, 0.05, 0.05]))
    zero = torch.zeros(n)
    es = _t(rng.normal(0, 2e4, ng).astype(np.float32))
    terms = w.double() * (DX * DX / DT)
    exact = torch.stack([terms[act == -1].sum(), -terms[act == 0].sum()])
    scale = float(terms.abs()[act != 1].sum())
    wall, j1, avg = [], [], []
    for fn in (good, bad):
        setattr(cuda_sheath, name, fn)
        try:
            jh = cuda_sheath.sheath_picard_plain(es, p0, p0, zero, zero, w, act,
                                                 dt=DT, dx=DX)[2]
            wall.append(float((jh[[0, -1]].double() - exact).abs().max()) / scale)
            step = sheath.make_step(cfg)
            st, _ = step(interop.sheath_state_from_numpy(d, "cpu"))
            j1.append(st.j)
            _, m = run(step, interop.sheath_state_from_numpy(d, "cpu"), 200)
        finally:
            setattr(cuda_sheath, name, good)
        avg.append(m.phi[-100:].double().mean(dim=0))
    assert wall[0] <= WALL_ONLY_LIMIT
    j_err = _rel(j1[0], j1[1])
    gap = float((avg[1] - avg[0]).abs().max()) / te_volts
    print(f"{where} x 1.01: wall-charge-only pass {wall[1]:.4e} of the wall "
          f"charge (limit {WALL_ONLY_LIMIT}); one step's j {j_err:.4e} of its "
          f"largest node (limit {STEP_J_LIMIT}); 200-step time-averaged phi "
          f"{gap:.4e} Te/e (limit {PHI_AVG_LIMIT})")
    assert wall[1] > WALL_ONLY_LIMIT or j_err > STEP_J_LIMIT or gap > PHI_AVG_LIMIT
