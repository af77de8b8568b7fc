"""A float64 magnetized state against pypic_tpu under x64, on the CPU: the
routes ``tests/test_torch_float64_engines.py`` leaves out, and the float64
plain Newton versions the card's double kernels are held to.

* The plain Newton versions (``cuda_newton.boltzmann_dirichlet_plain``,
  ``boltzmann_dn_plain``: the double kernels' PCR and partition solves,
  in float64) against JAX's ``solve_boltzmann_dirichlet`` and
  ``solve_boltzmann_dirichlet_neumann`` in float64 (XLA's loop, a Thomas
  solve an iteration) at 600, 800, 1,025 and 4,096 rows, at each solve's
  own tolerance and over 8 iterations at tol 0: the iterations equal,
  phi within NEWTON64 of its largest.
* One float64 step in both packages, the JAX draws replayed: the carried
  step (``carried_deposit='on'``, react_batch 512, the JAX table replayed
  at n = react_batch), ``dirichlet_neumann_test`` (fused and composed),
  ``pic_iead_gc`` (composed) and ``pic_iead`` on 2,048 nodes (fused and
  composed), each from the JAX state after one step, cast to float64.
  The active flags, re-activations, clamps and Newton iterations equal.
  As in ``tests/test_torch_float64_engines.py``: against JAX's composed
  float64 step the port stands within float64 summation order; against a
  JAX route whose Pallas kernels keep float32 accumulators (the fused
  deposit, the carried deposit) within twice the gap that route leaves
  to JAX's composed float64 step from the same state. The gaps measured
  are written beside each test.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import presets as jpresets
from pypic_tpu.constants import E_CHARGE
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.ops import poisson as jpoisson

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.ops import cuda_newton

from test_torch_carried import _replay as _carried_replay
from test_torch_dirichlet_neumann import _replay as _dn_replay
from test_torch_float64_engines import EPS64, _cast64, _gap, _mag_cfgs
from test_torch_gc import _replay as _gc_replay
from test_torch_magnetized import _replay as _mag_replay

TE, DX = 11600.0 * 10.0, 2e-5
N0_DD, N0_DN = 1e17, 0.9e17
# phi of a float64 plain Newton version against JAX's float64 solve,
# relative to its largest: the PCR and partition solves against Thomas in
# float64, each a few ulps of the iterate, carried over the iterations.
# Measured: D-D 2.8e-16 to 5.5e-16, D-N 3.3e-16 to 3.5e-15 (the
# Sherman-Morrison correction), 4 iterations at the row tolerance in each
# package.
NEWTON64 = 64 * EPS64


def _density(ng: int, seed: int) -> np.ndarray:
    """A number density of 1e17 m^-3 with 30% noise (the load of
    tests/test_torch_newton_large.py), in float64."""
    rng = np.random.default_rng(seed)
    return (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)


@pytest.mark.parametrize("ng", [600, 800, 1025, 4096])
@pytest.mark.parametrize("kind", ["dirichlet", "dirichlet_neumann"])
def test_float64_plain_newton_matches_jax(kind, ng):
    """The float64 plain Newton version against JAX's float64 solve, cold,
    at the engine's tol and maxiter (D-D 1e-9 and 1,000, D-N 1e-3 and 100)
    and over 8 iterations at tol 0: the same iterations, phi within
    NEWTON64 of its largest, float64 throughout."""
    n = _density(ng, ng)
    runs = {"row": (1e-9, 1000) if kind == "dirichlet" else (1e-3, 100),
            "8 iterations": (0.0, 8)}
    for label, (tol, maxiter) in runs.items():
        if kind == "dirichlet":
            rho = E_CHARGE * n
            ref = jpoisson.solve_boltzmann_dirichlet(
                jnp.asarray(rho), N0_DD, TE, DX, tol=tol, maxiter=maxiter)
            got = cuda_newton.boltzmann_dirichlet_plain(
                torch.from_numpy(rho), N0_DD, TE, DX, tol=tol, maxiter=maxiter)
        else:
            phi0 = np.zeros(ng)
            ref = jpoisson.solve_boltzmann_dirichlet_neumann(
                jnp.asarray(n), N0_DN, TE, DX, jnp.asarray(phi0), tol=tol,
                maxiter=maxiter)
            got = cuda_newton.boltzmann_dn_plain(
                torch.from_numpy(n), N0_DN, TE, DX, torch.from_numpy(phi0), tol=tol,
                maxiter=maxiter)
        assert np.asarray(ref.phi).dtype == np.float64
        assert got.phi.dtype == got.residual.dtype == torch.float64
        assert int(got.iterations) == int(ref.iterations), label
        assert _gap(ref.phi, got.phi.numpy()) <= NEWTON64, (label, _gap(ref.phi, got.phi.numpy()))


def _port_step(jcfg, jstate, hooks):
    _, tcfg = _mag_cfgs(jcfg)
    d = {k: np.asarray(getattr(jstate, k)) for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    return magnetized.make_step(tcfg, **hooks)(interop.magnetized_state_from_numpy(d, "cpu"))


def _after_one_step(jpre, **kw):
    """(config, the JAX state after one float32 step cast to float64)."""
    cfg = dc.replace(jpre.config, **kw)
    st = jpre.state
    if cfg.carried_deposit == "on":
        st = jmag.prime_carry(st, cfg)
    st1, _ = jax.jit(jmag.make_step(cfg))(st)
    return cfg, _cast64(st1)


# the carried rho and n against JAX's, relative to the largest node: the
# float32 accumulators of JAX's carried deposit (16 float32 ulps)
CARRIED_ACC = 16 * 2.0 ** -24
# the GC pack of a re-activated row, from float32 draws in float32 in both
# packages (JAX's draws stay float32 in a float64 state): the two
# to_guiding_center forms part there by float32 ulps (measured 4.2e-8 of
# p's largest, 7.7e-8 of vx's on those rows), as in the float32 tests
F32_PACK = 16 * 2.0 ** -24


def _hold(js, jm, ts, tm, ref, jmref, counts, fields, accumulated=(), packed=None):
    """The port's float64 step (ts, tm) against JAX's (js, jm) on the
    same route: the active flags and ``counts`` equal; each field of
    ``fields`` over the rows active after JAX's composed step (ref, jmref)
    within float64 summation order, or within twice JAX's own gap to
    ref for the ``accumulated`` fields (a route with float32 Pallas
    accumulators); the ``packed`` rows (a mask: the GC re-activations,
    packed in float32) within F32_PACK of their largest. Returns the gaps
    {field: (port to JAX, JAX's own)}."""
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    for k in counts:
        assert int(getattr(tm, k)) == int(getattr(jm, k)), k
    act = np.asarray(ref.active) == 1
    if packed is not None:
        for k in fields:
            if k not in ("rho", "phi"):
                a, b = np.asarray(getattr(js, k))[packed], getattr(ts, k).numpy()[packed]
                assert _gap(a, b) <= F32_PACK, (k, _gap(a, b))
        act = act & ~packed
    order = 64 * EPS64
    gaps = {}
    for k in fields:
        src = (jm, tm, jmref) if k in ("rho", "phi") else (js, ts, ref)
        same, got, base = (np.asarray(getattr(s, k)) if i != 1 else getattr(s, k).numpy()
                           for i, s in enumerate(src))
        if same.shape[0] == act.shape[0]:
            same, got, base = same[act], got[act], base[act]
        jgap = _gap(base, same)
        tol = max(2.0 * jgap, order) if k in accumulated else order
        gaps[k] = (_gap(same, got), jgap)
        assert gaps[k][0] <= tol, (k, gaps[k], tol)
    return gaps


@pytest.fixture(scope="module")
def iead_jpre():
    return jpresets.pic_iead(n_per_species=500)


def test_float64_carried_step_matches_jax(iead_jpre):
    """One carried float64 step (react_batch 512, the JAX table replayed)
    from a state whose carry is primed in float64 by JAX's composed
    deposit: the active flags, re-activations, carry_clamped and the
    Newton iterations equal; phi within float64 summation order; p and
    the velocities within twice the gap JAX's carried step (its Pallas
    kernel's float32 accumulators) leaves to JAX's composed uncarried
    float64 step from the same state; the carried rho and n within
    CARRIED_ACC of their largest (JAX sums the carried deposit's float64
    terms in float32 accumulators; both carry the same clamped tents, which
    put either 0.26 of the largest node from a fresh deposit). Measured: p
    1.6e-10 and vx 1.5e-8 of their largest from JAX's carried step (JAX's
    own gap 1.6e-10 and 1.5e-8: the port's step is JAX's composed one),
    phi 2.0e-16, the carried rho and n 4.7e-8."""
    cfg, st64 = _after_one_step(iead_jpre, carried_deposit="on", react_batch=512)
    composed = dc.replace(cfg, backend="composed")
    st64 = jmag.prime_carry(st64, composed)
    js, jm = jmag.make_step(cfg)(st64)
    ref, jmref = jmag.make_step(dc.replace(composed, carried_deposit="off"))(st64)
    # JAX's float64 deposit of its composed step's particles
    fresh = jmag.prime_carry(ref, composed)
    ts, tm = _port_step(cfg, st64, {"source_draws": _carried_replay(st64, cfg)})
    assert ts.p.dtype == ts.rho.dtype == tm.phi.dtype == torch.float64
    assert int(jm.n_reactivated) > 0
    gaps = _hold(js, jm, ts, tm, ref, jmref, ("n_reactivated", "n_hit_wall", "carry_clamped",
                                              "newton_iters"), ("p", "vx", "vy", "vz", "phi"),
                 ("p", "vx", "vy", "vz"))
    for k in ("rho", "n"):
        gaps[k] = (_gap(getattr(js, k), getattr(ts, k).numpy()),
                   _gap(getattr(fresh, k), getattr(js, k)))
        assert gaps[k][0] <= CARRIED_ACC, (k, gaps[k])
    print(gaps)


@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_float64_dirichlet_neumann_step_matches_jax(backend):
    """One float64 step of dirichlet_neumann_test (n = 4,000, ng = 800),
    the JAX flux draws replayed: the D-N Newton iterations, flags and
    counts equal; composed within float64 summation order, fused within
    twice the gap JAX's fused step (float32 deposit accumulators) leaves
    to its composed one. Measured: composed p 7.1e-17, vx 2.4e-16, phi
    3.7e-16; fused p 4.8e-11, vx 5.8e-9, phi 5.0e-8 (JAX's own gaps the
    same: the port's fused step is JAX's composed one)."""
    jpre = jpresets.dirichlet_neumann_test(n=4000, ng=800)
    cfg, st64 = _after_one_step(jpre, backend=backend)
    comp = dc.replace(cfg, backend="composed")
    js, jm = jmag.make_step(cfg)(st64)
    ref, jmref = jmag.make_step(comp)(st64)
    keys = {int(st64.step): st64.rng}
    ts, tm = _port_step(cfg, st64, {"source_draws": _dn_replay(cfg, keys)})
    assert ts.p.dtype == tm.phi.dtype == torch.float64
    fused = ("p", "vx", "vy", "vz", "phi") if backend == "fused" else ()
    print(_hold(js, jm, ts, tm, ref, jmref, ("n_reactivated", "n_hit_wall", "newton_iters"),
                ("p", "vx", "vy", "vz", "phi"), fused))


def test_float64_gc_step_matches_jax():
    """One float64 step of pic_iead_gc (n_per_species 500, composed: the
    GC path), the JAX source and gyro-phase draws replayed: flags, modes,
    counts and the Newton iterations equal; the guiding centers, v_par,
    mu and phi within float64 summation order, but the rows re-activated
    in the step, which both packages pack into GC coordinates in float32
    (their draws' dtype), within F32_PACK. Measured: p 0, vx 2.1e-18, vy
    0, phi 2.4e-16 off the re-activated rows; 4.2e-8, 7.7e-8, 2.5e-8 on
    the 774 re-activated."""
    jpre = jpresets.pic_iead_gc(n_per_species=500)
    cfg, st64 = _after_one_step(jpre)
    js, jm = jmag.make_step(cfg)(st64)
    ts, tm = _port_step(cfg, st64, _gc_replay(st64, cfg))
    assert ts.p.dtype == tm.phi.dtype == torch.float64
    np.testing.assert_array_equal(ts.mode.numpy(), np.asarray(js.mode))
    reactivated = (np.asarray(st64.active) != 1) & (np.asarray(js.active) == 1)
    assert reactivated.sum() == int(jm.n_reactivated) > 0
    print(_hold(js, jm, ts, tm, js, jm, ("n_reactivated", "n_hit_wall", "newton_iters"),
                ("p", "vx", "vy", "phi"), packed=reactivated))


@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_float64_step_above_1024_nodes_matches_jax(backend):
    """One float64 step of pic_iead (n_per_species 500) on 2,048 nodes,
    above the Newton kernels' one-CTA rows (the card takes the double
    large path there), the JAX draws replayed: as test_float64_dirichlet_
    neumann_step_matches_jax. Measured: composed p 1.1e-16, vx 4.8e-16,
    phi 3.9e-16; fused p 1.8e-10, vx 1.7e-8, rho 3.9e-8, phi 1.8e-8
    (JAX's own gaps the same)."""
    jpre = jpresets.pic_iead(n_per_species=500, ng=2048)
    cfg, st64 = _after_one_step(jpre, backend=backend)
    comp = dc.replace(cfg, backend="composed")
    js, jm = jmag.make_step(cfg)(st64)
    ref, jmref = jmag.make_step(comp)(st64)
    ts, tm = _port_step(cfg, st64, {"source_draws": _mag_replay(st64, cfg)})
    assert ts.p.dtype == tm.phi.dtype == torch.float64
    fused = ("p", "vx", "vy", "vz", "rho", "phi") if backend == "fused" else ()
    print(_hold(js, jm, ts, tm, ref, jmref, ("n_reactivated", "n_hit_wall", "newton_iters"),
                ("p", "vx", "vy", "vz", "rho", "phi"), fused))
