"""A float64 state through the explicit, magnetized and sheath engines,
against pypic_tpu under x64, on the CPU.

The same float64 state steps in both packages on every route the JAX
package runs it (its Pallas kernels in interpret mode, the port's plain
kernel versions); the magnetized and sheath steps replay JAX's draws
(``tests/test_torch_magnetized.py`` and ``tests/test_torch_sheath.py``
``_replay``). As in ``tests/test_torch_float64.py``: against JAX's
composed float64 step the port stands within float64 summation order;
against JAX's fused float64 step, whose Pallas kernels keep float32
accumulators (and the one-kernel explicit cycle a float32 field solve),
within twice the gap that step leaves to JAX's composed float64 step,
measured here. Each float64 gap stands at least 100x inside the gap of
the port's float32 step from the same state, measured against JAX's
composed float64 step (the same arithmetic on every route of these
engines). The gaps measured are written beside each test.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu.constants import E_CHARGE, M_ELECTRON
from pypic_tpu.engines import explicit as jexplicit
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.engines import sheath as jsheath
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.presets import pic_iead as jpic_iead
from pypic_tpu.presets import sheath_dd as jsheath_dd
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import explicit, magnetized, sheath
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.runner import run

from test_torch_magnetized import _replay as _mag_replay
from test_torch_sheath import _replay as _sheath_replay
from test_torch_sheath import _tcfg_of as _sheath_cfg

EPS64 = 2.0 ** -52


def _gap(ref, got, cells=None):
    """Largest gap relative to ref's largest magnitude; in cells where
    ``cells`` is given (periodic positions: a pair across the seam the
    short way)."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    d = np.abs(ref - got)
    if cells is not None:
        return float(np.minimum(d, cells - d).max())
    return float(d.max() / max(np.abs(ref).max(), 1e-300))


def _cast64(state):
    """A JAX state with its float32 fields cast to float64."""
    return dc.replace(state, **{
        f.name: getattr(state, f.name).astype(jnp.float64) for f in dc.fields(state)
        if getattr(getattr(state, f.name), "dtype", None) == jnp.float32})


# ---------------------------------------------------------------------------
# explicit: the one-kernel cycle (ng <= 1024), the two-stage sweep above
# it, and the composed route; two-stream, n = 4,096, two steps
# ---------------------------------------------------------------------------

EXPLICIT_N, EXPLICIT_STEPS = 4096, 2
EXPLICIT_ROUTES = {"one-kernel ng 64": (64, "auto"), "fused ng 2048": (2048, "auto"),
                   "composed ng 64": (64, "composed")}
EXPLICIT_Q = ("p", "v", "rho", "e")


def _explicit_runs(ng, backend):
    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(1.380649e-23 * te * 8.8541878128e-12 / 1.602176634e-19**2 / density)
    length = 16.0 * debye
    x, v, par = jinit.initialize_periodic("two-stream", EXPLICIT_N, density, 1, 0.05,
                                          JGridSpec(ng, length, "periodic"), te, te, seed=2)
    out = {}
    for b in dict.fromkeys((backend, "composed")):
        jc = jexplicit.ExplicitConfig(JGridSpec(ng, length, "periodic"), 0.1 / par.wp,
                                      par.p2c, backend=b)
        js0 = jexplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jc, dtype=jnp.float64)
        out[f"jax {b}"] = jrun(jexplicit.make_step(jc), js0, EXPLICIT_STEPS)[0]
    tc = explicit.ExplicitConfig(GridSpec(ng, length, "periodic"), 0.1 / par.wp,
                                 par.p2c, backend=backend)
    for label, dtype in (("port64", torch.float64), ("port32", torch.float32)):
        st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tc, dtype=dtype,
                                 device="cpu")
        out[label] = run(explicit.make_step(tc), st, EXPLICIT_STEPS)[0]
    return out


@pytest.mark.parametrize("route", sorted(EXPLICIT_ROUTES))
def test_explicit_float64_step_matches_jax(route):
    """Measured: the port's float64 steps stand 1.4e-14 cells and 6.7e-15
    of max |e| (one-kernel), 4.5e-13 cells and 7.0e-14 of e (ng 2048)
    from JAX's composed float64 step; JAX's fused float64 step leaves it
    1.1e-8 cells and 2.8e-6 of e (its float32 field solve) at ng 64,
    2.3e-8 cells and 4.8e-8 of e at 2048. The port's float32 steps stand
    7.5e-6 cells and 8.9e-7 of e (ng 64) and 3.3e-4 cells and 3.3e-4 of
    e (2048) from it."""
    ng, backend = EXPLICIT_ROUTES[route]
    out = _explicit_runs(ng, backend)
    ref, same = out["jax composed"], out[f"jax {backend}"]
    assert out["port64"].p.dtype == out["port64"].e.dtype == torch.float64
    for k in EXPLICIT_Q:
        cells = ng if k == "p" else None
        g64 = _gap(getattr(same, k), getattr(out["port64"], k), cells)
        # JAX's fused route: its own gap to its composed float64 step
        jgap = _gap(getattr(ref, k), getattr(same, k), cells)
        tol = 2.0 * jgap if backend != "composed" else 16 * EXPLICIT_N * EPS64 * ng
        assert jgap < 1e-5 and g64 <= max(tol, 16 * EXPLICIT_N * EPS64 * ng), (k, g64, tol)
        exact = _gap(getattr(ref, k), getattr(out["port64"], k), cells)
        g32 = _gap(getattr(ref, k), getattr(out["port32"], k), cells)
        assert 100.0 * exact <= g32, (k, exact, g32)


# ---------------------------------------------------------------------------
# magnetized: pic_iead(500), the JAX state after one step cast to float64,
# fused and composed, the Newton 'xla' and 'pallas' settings (JAX sends a
# float64 state to XLA either way, pypic_tpu/engines/magnetized.py:851-854,
# and so does the port)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def iead_state():
    jpre = jpic_iead(n_per_species=500)
    js1, _ = jmag.make_step(jpre.config)(jpre.state)
    return jpre.config, js1


def _mag_cfgs(jcfg, **kw):
    jcfg = dc.replace(jcfg, **kw)
    tcfg = magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source")},
        grid=GridSpec(jcfg.grid.ng, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(jcfg.source)))
    return jcfg, tcfg


def _mag_port_step(tcfg, jcfg, jstate):
    d = {k: np.asarray(getattr(jstate, k)) for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    st = interop.magnetized_state_from_numpy(d, "cpu")
    return magnetized.make_step(tcfg, source_draws=_mag_replay(jstate, jcfg))(st)


@pytest.mark.parametrize("newton", ["xla", "pallas"])
@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_magnetized_float64_step_matches_jax(iead_state, backend, newton):
    """One float64 step. Measured against JAX's composed float64 step:
    the port's float64 steps 1.9e-16 of p and 2.0e-16 of vx or less, on
    either route; JAX's fused float64 step, with its float32 deposit
    accumulators, 1.4e-10 of p, 1.4e-8 of vx and 2.9e-8 of rho; the
    port's float32 step 5.1e-8 (fused) and 1.3e-7 (composed) of p, 8.6e-8
    of vx and 1.0e-7 of rho."""
    jcfg0, js1 = iead_state
    jcfg, tcfg = _mag_cfgs(jcfg0, backend=backend, newton_backend=newton)
    jcomp, _ = _mag_cfgs(jcfg0, backend="composed", newton_backend=newton)
    st64 = _cast64(js1)
    js, jm = jmag.make_step(jcfg)(st64)
    jref, jmref = jmag.make_step(jcomp)(st64)
    ts, tm = _mag_port_step(tcfg, jcfg, st64)
    t32, tm32 = _mag_port_step(tcfg, jcfg, js1)
    assert ts.p.dtype == ts.vx.dtype == tm.phi.dtype == torch.float64
    assert t32.p.dtype == torch.float32
    act = np.asarray(jref.active) == 1
    assert np.array_equal(ts.active.numpy(), np.asarray(js.active))
    order = 64 * EPS64
    rows = {k: (np.asarray(getattr(js, k))[act], getattr(ts, k).numpy()[act],
                np.asarray(getattr(jref, k))[act], getattr(t32, k).numpy()[act])
            for k in ("p", "vx", "vy", "vz")}
    rows.update({k: (np.asarray(getattr(jm, k)), getattr(tm, k).numpy(),
                     np.asarray(getattr(jmref, k)), getattr(tm32, k).numpy())
                 for k in ("rho", "phi")})
    for k, (same, got, ref, got32) in rows.items():
        jgap = _gap(ref, same)
        tol = 2.0 * jgap if backend == "fused" else order
        assert jgap < 1e-6 and _gap(same, got) <= max(tol, order), (k, _gap(same, got), tol)
        assert 100.0 * _gap(ref, got) <= _gap(ref, got32), (k, _gap(ref, got),
                                                             _gap(ref, got32))
    assert int(tm.newton_iters) == int(jm.newton_iters)
    assert int(tm.n_reactivated) == int(jm.n_reactivated) > 0
    np.testing.assert_allclose(float(tm.n0), float(jm.n0), rtol=order)


# ---------------------------------------------------------------------------
# sheath: sheath_dd(n = 4,000) cast to float64, the composed route, JAX's
# draws replayed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps_before", [0, 5])
def test_sheath_float64_composed_step_matches_jax(steps_before):
    """One composed float64 step from sheath_dd's state (and from its
    state five steps on), the JAX re-injection draws replayed in float64:
    the Picard counts, losses and statuses equal; positions, u, e and j
    within float64 summation order (measured 7.1e-17 of p, 7.4e-16 of j
    or less), 100x inside the port's float32 step from the float32 state
    (5.0e-8 of u and more at step 0; at step 5 its float32 draws place
    the re-injected rows elsewhere)."""
    pre = jsheath_dd(n=4000)
    cfg = dc.replace(pre.config, backend="composed")
    st = pre.state
    step = jax.jit(jsheath.make_step(cfg))
    for _ in range(steps_before):
        st, _ = step(st)
    st64 = _cast64(st)
    js, jm = jax.jit(jsheath.make_step(cfg))(st64)
    tcfg = _sheath_cfg(cfg)
    outs = {}
    for label, jst in (("port64", st64), ("port32", st)):
        d = {k: np.asarray(getattr(jst, k)) for k in interop._SHEATH_FIELDS + ("rng",)}
        outs[label] = sheath.make_step(tcfg, reinject_draws=_sheath_replay(jst, cfg))(
            interop.sheath_state_from_numpy(d, "cpu"))
    ts, tm = outs["port64"]
    t32, _ = outs["port32"]
    assert ts.p.dtype == ts.e.dtype == torch.float64
    assert int(tm.picard_iters) == int(jm.picard_iters)
    assert int(tm.n_lost_left) == int(jm.n_lost_left)
    assert int(tm.n_lost_right) == int(jm.n_lost_right)
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    order = 16 * 4000 * EPS64
    for k in ("p", "u", "e", "j"):
        g64 = _gap(getattr(js, k), getattr(ts, k))
        g32 = _gap(getattr(js, k), getattr(t32, k))
        assert g64 <= order, (k, g64)
        assert 100.0 * g64 <= g32, (k, g64, g32)
