"""A float64 state through the implicit engine, against pypic_tpu under x64.

One numpy Landau load (the reference preset's plasma, perturbation 0.8,
n = 4,096, ng = 200, L = 22 debye) goes through ``init_state`` and three
conserving steps in both packages, in float64, on every route the JAX
package runs it: the fused step (separate and shared window; finalize
'converged', 'converged-deposit' and 'iterate') and the composed one. The
JAX fused step runs its Pallas kernels in interpret mode, the port its
plain kernel versions (the tensors lie on the CPU).

The tolerances follow from what JAX's float64 route computes. Its
composed step is float64 throughout: the port's stands within float64
summation order of it (16 n eps64; measured 8.5e-14 cells of p, 1.3e-14
of max |e|). Its fused Pallas kernels keep their deposit accumulators in
float32 (``pallas_cic.py`` ``preferred_element_type``), while the port's
accumulate in float64; the port's fused step is held to twice the gap
that JAX's own fused float64 step leaves to its composed float64 step,
measured here (2.5e-7 cells of p, 1.8e-8 of v, 4.3e-9 of e), and its
current to twice that gap in the full-step current of
finalize='converged-deposit' (6.8e-8), where both routes return the same
current. Each float64 gap also stands at least 100x inside the gap of the
port's float32 step from the same load (measured 2.2e-4 cells, 1.6e-5 of
v, 5.8e-5 of e, 1.1e-4 of j): the state is float64 throughout, not
float32 cast up.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu.constants import E_CHARGE, EPSILON_0, EV_TO_K, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.engines import implicit as jimplicit
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import implicit
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.runner import run

CONSERVING = dict(tol=1e-30, maxiter=4, picard_init="extrapolate",
                  picard_accel="anderson", finalize="converged",
                  finalize_field="last", window_share="auto")
N, NG, STEPS = 4096, 200, 3
EPS64 = 2.0 ** -52
# float64 summation order: a node sums up to 2n terms
TOL_ORDER = 16 * N * EPS64
ROUTES = {
    "fused": {}, "fused-shared": dict(window_share="shared"),
    "fused-converged-deposit": dict(finalize="converged-deposit"),
    "fused-iterate": dict(finalize="iterate"),
    "composed": dict(backend="composed"),
}
Q = ("p", "v", "e", "j")


def _gap(ref, got, key):
    """Largest gap: in cells for p (a pair across the seam counted the
    short way), else relative to ref's largest magnitude."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    d = np.abs(ref - got)
    if key == "p":
        return float(np.minimum(d, NG - d).max())
    return float(d.max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def load():
    density, te, ti = 1e5, 100.0 * EV_TO_K, 0.1 * EV_TO_K
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    length = 22.0 * debye
    x, v, params = jinit.initialize_periodic(
        "landau-damping", N, density, 1, 0.8, JGridSpec(NG, length, "periodic"),
        te, ti, seed=1)
    return length, x, v, params


def _configs(load, **kw):
    length, _, _, params = load
    opts = dict(CONSERVING, **kw)
    return (jimplicit.ImplicitConfig(JGridSpec(NG, length, "periodic"), 1e-5,
                                     params.p2c, **opts),
            implicit.ImplicitConfig(GridSpec(NG, length, "periodic"), 1e-5,
                                    params.p2c, **opts))


def _jax_run(load, jcfg):
    _, x, v, _ = load
    st = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg, dtype=jnp.float64)
    return jrun(jimplicit.make_step(jcfg), st, STEPS)


def _port_run(load, tcfg, dtype):
    _, x, v, _ = load
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg, dtype=dtype,
                             device="cpu")
    return run(implicit.make_step(tcfg), st, STEPS)


@pytest.fixture(scope="module")
def jax_gaps(load):
    """The gaps JAX's float32 accumulators leave: its fused float64 step
    against its composed float64 step (p, v, e of the conserving fused
    step; j of finalize='converged-deposit', whose full-step current the
    composed step returns too)."""
    jcomp = _jax_run(load, _configs(load, backend="composed")[0])[0]
    fused = _jax_run(load, _configs(load)[0])[0]
    deposit = _jax_run(load, _configs(load, finalize="converged-deposit")[0])[0]
    gaps = {k: _gap(getattr(jcomp, k), getattr(fused, k), k) for k in ("p", "v", "e")}
    gaps["j"] = _gap(jcomp.j, deposit.j, "j")
    return gaps


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_float64_step_matches_jax(load, jax_gaps, route):
    """Three float64 steps on one route in both packages: every field
    stays float64; p, v, e, j within float64 summation order of JAX's
    composed step, or within twice JAX's own float32-accumulator gap of
    its fused step; the Picard counts and the clamps equal; and each gap
    at least 100x inside the port's float32 step's."""
    jcfg, tcfg = _configs(load, **ROUTES[route])
    js, jm = _jax_run(load, jcfg)
    ts, tm = _port_run(load, tcfg, torch.float64)
    t32, _ = _port_run(load, tcfg, torch.float32)
    for k in ("p", "v", "e", "j", "e_prev", "e_prev2"):
        assert getattr(ts, k).dtype == torch.float64, k
    assert tm.field_energy.dtype == tm.kinetic_energy.dtype == torch.float64
    fused = route != "composed"
    # JAX's fused float64 route is within its float32 accumulators of
    # float64: the limits it sets stand far below float32's gaps
    assert max(jax_gaps.values()) < 1e-6, jax_gaps
    for k in Q:
        g64 = _gap(getattr(js, k), getattr(ts, k), k)
        g32 = _gap(getattr(js, k), getattr(t32, k), k)
        tol = 2.0 * jax_gaps[k] if fused else TOL_ORDER
        assert g64 <= tol, (route, k, g64, tol)
        assert 100.0 * g64 <= g32, (route, k, g64, g32)
    np.testing.assert_array_equal(tm.picard_iters.numpy(), np.asarray(jm.picard_iters))
    np.testing.assert_array_equal(tm.picard_clamped.numpy(), np.asarray(jm.picard_clamped))
    for name in ("field_energy", "kinetic_energy"):
        ref = np.asarray(getattr(jm, name))
        np.testing.assert_allclose(getattr(tm, name).numpy(), ref, rtol=0,
                                   atol=(2.0 * max(jax_gaps.values()) if fused
                                         else TOL_ORDER) * np.abs(ref).max())


def test_float64_init_state_matches_jax(load):
    """init_state in float64: the positions bit-equal, the set-up field
    and current within float64 summation order of JAX's."""
    jcfg, tcfg = _configs(load)
    _, x, v, _ = load
    js = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg, dtype=jnp.float64)
    ts = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg, dtype=torch.float64,
                             device="cpu")
    np.testing.assert_array_equal(ts.p.numpy(), np.asarray(js.p))
    assert ts.q.dtype == ts.m.dtype == torch.float64
    for k in ("e", "j"):
        assert _gap(getattr(js, k), getattr(ts, k), k) <= TOL_ORDER, k


def test_float32_state_carried_into_float64(load):
    """A carried float32 JAX state cast to float64 (its step stays
    int32) keeps float64 through interop, and the port's float64 step from
    it is JAX's float64 step from the same cast within summation order
    (composed); the round trip keeps float64."""
    jcfg, tcfg = _configs(load, backend="composed")
    _, x, v, _ = load
    j32 = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    d = {k: np.asarray(getattr(j32, k)) for k in interop._FIELDS}
    assert d["p"].dtype == np.float32
    d = {k: a.astype(np.float64) if a.dtype.kind == "f" else a for k, a in d.items()}
    ts = interop.implicit_state_from_numpy(d, "cpu")
    assert ts.p.dtype == ts.e.dtype == ts.q.dtype == torch.float64
    assert ts.step.dtype == torch.int32
    j64 = dataclasses.replace(j32, **{k: jnp.asarray(d[k])
                                      for k in interop._FIELDS if k != "step"})
    js1, _ = jimplicit.make_step(jcfg)(j64)
    ts1, _ = implicit.make_step(tcfg)(ts)
    for k in Q:
        assert _gap(getattr(js1, k), getattr(ts1, k), k) <= TOL_ORDER, k
    back = interop.implicit_state_to_numpy(ts1)
    assert back["p"].dtype == np.float64 and back["step"].dtype == np.int32


@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_float64_axis_name_on_one_rank_is_the_one_device_step(load, backend):
    """axis_name (data parallel) on one rank in float64: the sums keep
    the dtype, and the step equals the one-device step bit for bit."""
    _, tcfg = _configs(load, backend=backend)
    _, x, v, _ = load
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg, dtype=torch.float64,
                             device="cpu")
    a, ma = implicit.make_step(tcfg)(st)
    b, mb = implicit.make_step(dataclasses.replace(tcfg, axis_name="particles"))(st)
    assert b.p.dtype == b.j.dtype == mb.kinetic_energy.dtype == torch.float64
    assert torch.equal(a.p, b.p) and torch.equal(a.e, b.e) and torch.equal(a.j, b.j)
    for k, val in ma._asdict().items():
        assert torch.equal(val, getattr(mb, k)), k


@pytest.mark.parametrize("opts", [dict(picard_accel="anderson2"),
                                  dict(finalize_field="mean2"),
                                  dict(finalize_field="aitken", tol=1e-13, maxiter=20,
                                       picard_accel="none")],
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_float64_options_match_jax(load, jax_gaps, opts):
    """The fused step's other options in float64 (the mixer over two
    histories, the finalize field, a tolerance exit): one step each,
    within twice JAX's float32-accumulator gap, the Picard counts equal."""
    jcfg, tcfg = _configs(load, **opts)
    _, x, v, _ = load
    js0 = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg, dtype=jnp.float64)
    js, jm = jimplicit.make_step(jcfg)(js0)
    ts, tm = implicit.make_step(tcfg)(
        implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg, dtype=torch.float64,
                            device="cpu"))
    assert int(tm.picard_iters) == int(jm.picard_iters)
    for k in ("p", "v", "e"):
        assert _gap(getattr(js, k), getattr(ts, k), k) <= 2.0 * jax_gaps[k], k
