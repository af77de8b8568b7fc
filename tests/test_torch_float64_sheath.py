"""A float64 sheath state through the port's dispatching wrappers on the
CPU, against pypic_tpu under x64.

The fused backend (``cuda_sheath.sheath_picard`` / ``sheath_finalize``,
``cuda_rng.sheath_reinject``) and the 'hash' sampler (``sources.hash_*``,
``cuda_rng.hash_batch``) keep the state's dtype from end to end, as the
JAX engine does: its Pallas sheath pass pushes in the state's dtype and
the hash sampler draws in it (pypic_tpu/engines/sheath.py passes
``p0.dtype.type``). Against JAX's composed float64 step the port stands
within float64 summation order; against JAX's fused float64 step, whose
Pallas pass keeps a float32 current accumulator (pallas_cic.py
``_sheath_call``), within twice the gap that accumulator leaves, measured
here. The float32 forms stay the float32 formulas, bit for bit.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import sources as jsources
from pypic_tpu.engines import sheath as jsheath
from pypic_tpu.presets import sheath_dd as jsheath_dd

from pypic_tpu_torch import interop, sources
from pypic_tpu_torch.engines import sheath
from pypic_tpu_torch.ops import cuda_cic, cuda_rng, cuda_sheath

from test_torch_dataparallel import sheath_seeds
from test_torch_float64_engines import _cast64, _gap
from test_torch_sheath import _replay, _tcfg_of

EPS64 = 2.0 ** -52
N = 4000
# float64 summation order of a node sum over the step's 4,000 rows
ORDER = 16 * N * EPS64
FIELDS64 = ("p", "u", "vy", "vz", "q", "m", "e", "j", "e_prev", "exit_hist")


def _jax_after(steps: int, **over):
    """sheath_dd(n = 4,000) after ``steps`` float32 composed JAX steps
    (rows lost to the walls by then), cast to float64, and the config."""
    pre = jsheath_dd(n=N)
    cfg = dc.replace(pre.config, backend="composed", **over)
    st = pre.state
    step = jax.jit(jsheath.make_step(cfg))
    for _ in range(steps):
        st, _ = step(st)
    return _cast64(st), cfg


def _port_state(jst):
    d = {k: np.asarray(getattr(jst, k)) for k in interop._SHEATH_FIELDS + ("rng",)}
    return interop.sheath_state_from_numpy(d, "cpu")


def _jax_step(cfg, st, **over):
    return jax.jit(jsheath.make_step(dc.replace(cfg, **over)))(st)


@pytest.mark.parametrize("steps_before", [0, 5])
def test_sheath_float64_fused_step_matches_jax(steps_before):
    """One fused float64 step (JAX's threefry draws replayed): every float
    field stays float64; statuses and losses equal JAX's fused and
    composed steps'; p, u, e and j within float64 summation order of
    JAX's composed float64 step (measured 7.8e-16 of p, 1.5e-13 of u,
    1.7e-12 of j or less: the fused step takes x1, u1 and j1 from a
    finalize over the converged field, the composed one from the last
    iterate); j within twice JAX's fused step's own gap to its composed
    step (4.0e-8 and 4.2e-8: its float32 accumulator).

    The Picard count equals JAX's composed step's. JAX's fused step may
    take one pass more (6 against 5 from the initial state): after the
    port's last pass its residual stands above tol, by no more than its
    float32 accumulator moves the field, where the float64 loops' stands
    below it; asserted from JAX's fused step cut at the port's count."""
    st64, cfg = _jax_after(steps_before)
    jc, jmc = _jax_step(cfg, st64)
    jf, jmf = _jax_step(cfg, st64, backend="fused")
    tcfg = dc.replace(_tcfg_of(cfg), backend="fused")
    ts, tm = sheath.make_step(tcfg, reinject_draws=_replay(st64, cfg))(_port_state(st64))
    for k in FIELDS64:
        assert getattr(ts, k).dtype == torch.float64, k
    assert float(tm.picard_residual) < float("inf")
    for js, jm in ((jc, jmc), (jf, jmf)):
        np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
        assert int(tm.n_lost_left) == int(jm.n_lost_left)
        assert int(tm.n_lost_right) == int(jm.n_lost_right)
    k = int(tm.picard_iters)
    assert k == int(jmc.picard_iters)
    for q in ("p", "u", "e", "j"):
        assert _gap(getattr(jc, q), getattr(ts, q)) <= ORDER, q
    accumulator = _gap(jc.j, jf.j)
    assert _gap(jf.j, ts.j) <= 2.0 * accumulator, (_gap(jf.j, ts.j), accumulator)
    kf = int(jmf.picard_iters)
    assert kf in (k, k + 1), (k, kf)
    if kf == k + 1:
        # JAX's fused loop cut at the port's count, and one pass before it:
        # the residual gap is at most the two passes' field gaps
        cut = {m: _jax_step(cfg, st64, backend="fused", maxiter=m) for m in (k - 1, k)}
        comp = {m: _jax_step(cfg, st64, maxiter=m) for m in (k - 1, k)}
        moved = sum(float(np.linalg.norm(np.asarray(cut[m][0].e) - np.asarray(comp[m][0].e)))
                    for m in (k - 1, k))
        r_fused, r64 = float(cut[k][1].picard_residual), float(tm.picard_residual)
        assert r64 <= cfg.tol < r_fused <= r64 + moved, (r64, r_fused, moved)


@pytest.mark.parametrize("backend", ["composed", "fused"])
def test_sheath_float64_hash_step_matches_jax(backend):
    """One float64 step on the 'hash' sampler with a thermostat (gamma
    0.05), JAX's seeds injected (``hash_seeds``), from a state with rows
    lost to the walls: the port's draws are float64, its uniforms JAX's
    bit for bit and its normals within 4 float64 ulps of JAX's; no
    thermostat uniform straddles gamma (the uniforms are equal); statuses,
    losses and the Picard count equal JAX's composed float64 step's; p,
    u, vy, vz, e and j within float64 summation order of it."""
    st64, cfg = _jax_after(5, gamma=0.05, rng_sampler="hash")
    js, jm = _jax_step(cfg, st64)
    seeds = sheath_seeds(st64.rng, 1)[0]
    lost = np.asarray(st64.active) != 1
    assert lost.sum() > 0
    n = st64.p.shape[0]
    for name in ("therm_u", "reinj_x"):
        got = sources.hash_uniforms(seeds[name], n, 1, device="cpu", dtype=torch.float64)
        ref = np.asarray(jsources.hash_uniforms(seeds[name], n, 1, jnp.float64))
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), ref)
    for name in ("therm_v", "reinj_v"):
        got = sources.hash_normals(seeds[name], n, 2, device="cpu", dtype=torch.float64)
        ref = np.asarray(jsources.hash_normals(seeds[name], n, 2, jnp.float64))
        assert got.dtype == torch.float64
        assert np.all(np.abs(got.numpy() - ref) <= 4 * np.spacing(np.abs(ref)))
    u_th = np.asarray(jsources.hash_uniforms(seeds["therm_u"], n, 1, jnp.float64))[0]
    straddle = np.abs(u_th - 0.05) <= 4 * np.spacing(0.05)
    assert int(straddle.sum()) == 0
    tcfg = dc.replace(_tcfg_of(cfg), backend=backend)
    ts, tm = sheath.make_step(tcfg, hash_seeds=lambda step: seeds)(_port_state(st64))
    for k in FIELDS64:
        assert getattr(ts, k).dtype == torch.float64, k
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    assert int(tm.picard_iters) == int(jm.picard_iters)
    assert int(tm.n_lost_left) == int(jm.n_lost_left)
    assert int(tm.n_lost_right) == int(jm.n_lost_right)
    for q in ("p", "u", "vy", "vz", "e", "j"):
        assert _gap(getattr(js, q), getattr(ts, q)) <= ORDER, (q, _gap(getattr(js, q),
                                                                        getattr(ts, q)))


@pytest.mark.parametrize("offset", [0, 2**32 - 500])
@pytest.mark.parametrize("streams", [1, 4, 6])
def test_hash_batch_plain_float64_matches_jax(streams, offset):
    """``hash_batch_plain(dtype=float64)`` against pypic_tpu.sources under
    x64: the uniforms ((h >> 8) + 1/2) 2^-24, exact in float64, bit for
    bit; the normals (float64 log, sqrt, cos and sin of the float64 angle
    (2 pi) u) within 4 float64 ulps of each value."""
    n, seed = 3000, 0x9E3779B9 ^ streams
    got = cuda_rng.hash_batch_plain(seed, n, streams, offset, dtype=torch.float64)
    ref = np.asarray(jsources.hash_uniforms(seed, n, streams, jnp.float64, offset=offset))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert float(got.max()) < 1.0 and float(got.min()) > 0.0
    if streams % 2 == 0:
        z = cuda_rng.hash_batch(seed, n, streams, offset=offset, normals=True,
                                device="cpu", dtype=torch.float64)
        zr = np.asarray(jsources.hash_normals(seed, n, streams // 2, jnp.float64,
                                              offset=offset))
        assert z.dtype == torch.float64
        ulps = np.abs(z.numpy() - zr) / np.spacing(np.abs(zr))
        assert float(ulps.max()) <= 4.0, float(ulps.max())


def _float32_sheath_scalars(dt, dx):
    """sheath_scalars' float32 values, written out: dt and dt/dx rounded
    to float32, c in float32 arithmetic, wall_ratio rounded."""
    f32 = np.float32
    dt32, dt_dx32 = f32(dt), f32(dt / dx)
    c = f32(0.5) * dt32 * dt_dx32
    return float(dt32), float(dt_dx32), float(c), float(f32(dx * dx / dt))


def test_float32_forms_match_their_formulas():
    """The float32 scalars, hash draws and padded outputs are the float32
    formulas written out, bit for bit, and float32 stays every wrapper's
    default dtype."""
    for dt, dx in ((1e-12, 1e-5), (3.7e-11, 2.2e-6)):
        assert cuda_sheath.sheath_scalars(dt, dx, torch.float32) == _float32_sheath_scalars(dt, dx)
        assert cuda_sheath.sheath_scalars(dt, dx) == _float32_sheath_scalars(dt, dx)
    n, seed = 2000, 77
    u32 = cuda_rng.hash_batch_plain(seed, n, 4, 5, dtype=torch.float32)
    idx = (torch.arange(n, dtype=torch.int64) + 5) & 0xFFFFFFFF
    offs = torch.tensor([((s + 1) * 0x9E3779B9) & 0xFFFFFFFF for s in range(4)])[:, None]
    h = cuda_rng.mix32_plain(cuda_rng.mix32_plain((idx[None, :] + offs) & 0xFFFFFFFF) ^ seed)
    assert u32.dtype == torch.float32
    assert torch.equal(u32, ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24)
    assert torch.equal(u32, torch.from_numpy(np.array(jsources.hash_uniforms(
        seed, n, 4, jnp.float32, offset=5))))
    z32 = cuda_rng.hash_batch(seed, n, 4, offset=5, normals=True, device="cpu",
                              dtype=torch.float32)
    r = torch.sqrt(-2.0 * torch.log(u32[0::2].double())).float()
    t = (float(np.float32(2 * np.pi)) * u32[1::2]).double()
    assert torch.equal(z32, torch.cat([r * torch.cos(t).float(), r * torch.sin(t).float()]))
    for rows in cuda_cic.padded_rows(3, 10, "cpu"), cuda_cic.padded_rows(
            3, 10, "cpu", torch.float32):
        assert all(t_.dtype == torch.float32 for t_ in rows)


def _pass_inputs(dtype, n=3001, ng=51, seed=4):
    rng = np.random.default_rng(seed)
    cells = ng - 1
    es = rng.normal(0.0, 2e4, ng)
    p0 = rng.uniform(0.0, cells, n)
    p0[:20] = rng.uniform(0.0, 0.05, 20)
    u0 = rng.normal(0.0, 1e6, n)
    qm = np.where(rng.uniform(size=n) < 0.5, -1.76e11, 9.6e7)
    w = np.where(qm < 0, -1.6e-9, 1.6e-9)
    act = rng.choice([1.0, 0.0, -1.0], n, p=[0.9, 0.05, 0.05])
    return [torch.as_tensor(a, dtype=dtype) for a in (es, p0, p0, u0, qm, w, act)]


@pytest.mark.parametrize("final", [False, True])
def test_sheath_pass_keeps_float64(final):
    """The pass and the finalize on float64 tensors return float64 views of
    one row-padded buffer, equal to their float64 plain versions, and a
    second pass takes the first's outputs (float32 buffers would make it
    raise 'tensors of different dtypes'); the current sums the wall
    charge with the float64 dx^2/dt."""
    args = _pass_inputs(torch.float64)
    kw = dict(dt=1e-12, dx=1e-5)
    fn = cuda_sheath.sheath_finalize if final else cuda_sheath.sheath_picard
    plain = cuda_sheath.sheath_finalize_plain if final else cuda_sheath.sheath_picard_plain
    got, ref = fn(*args, **kw), plain(*args, **kw)
    assert all(t.dtype == torch.float64 for t in got)
    assert all(t.data_ptr() % 16 == 0 for t in got[:-1])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if not final:
        xh, act1, _ = got
        again = cuda_sheath.sheath_picard(args[0], xh, *args[2:6], act1, **kw)
        assert again[0].dtype == torch.float64
    assert cuda_sheath.sheath_scalars(1e-12, 1e-5, torch.float64)[3] == 1e-5 * 1e-5 / 1e-12


def test_sheath_scalars_float64_are_jax_scal():
    """(dt, dt/dx, c, wall_ratio) in float64: the Pallas call's scal in the
    state's dtype (pallas_cic.py ``_sheath_call``) and the kernel's
    0.5 dt dt_dx, bit for bit; wall_ratio JAX's Python float."""
    for dt, dx in ((1e-12, 1e-5), (3.7e-11, 2.2e-6), (2.5e-12, 7.3e-6)):
        dt_j = jnp.asarray(dt, jnp.float64)
        dt_dx_j = jnp.asarray(dt / dx, jnp.float64)
        c_j = 0.5 * dt_j * dt_dx_j
        got = cuda_sheath.sheath_scalars(dt, dx, torch.float64)
        assert got == (float(dt_j), float(dt_dx_j), float(c_j), float(dx * dx / dt))


@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_sheath_reinject_float64_on_the_cpu(gamma):
    """The re-injection on float64 tensors: float64 outputs equal to its
    plain version, which keeps the float32 draws and multiplies them into
    the float64 sigmas; rows that draw nothing keep their float64 values
    bit for bit."""
    n = 5000
    rng = np.random.default_rng(9)
    p, u, vy, vz = (torch.as_tensor(rng.normal(size=n) * s) for s in (20.0, 1e6, 1e6, 1e6))
    p = p.abs()
    act = torch.as_tensor(rng.choice([1.0, 0.0, -1.0], n, p=[0.8, 0.1, 0.1]))
    sig = torch.as_tensor(rng.uniform(1e4, 1e6, n))
    got = cuda_rng.sheath_reinject((0, 7), 3, p, u, vy, vz, act, sig, cells=50.0,
                                   gamma=gamma)
    ref = cuda_rng.sheath_reinject_plain((0, 7), 3, p, u, vy, vz, act, sig, cells=50.0,
                                         gamma=gamma)
    assert all(t.dtype == torch.float64 for t in got)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    keep = (act == 1.0).numpy()
    if gamma == 0.0:
        for g, x in zip(got, (p, u, vy, vz)):
            assert torch.equal(g[keep], x[keep])
    lost = ~keep
    uni = cuda_rng.sheath_uniforms((0, 7), 3, n, gamma=gamma, device="cpu")
    assert torch.equal(got[0][lost], (uni[4] * np.float32(50.0)).double()[lost])
