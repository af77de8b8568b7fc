"""The options of the port's engines that mix, redirect or reduce
(``ops.accel``'s Anderson(2) and Anderson(M), the implicit engine's
``finalize_field``, ``deposit_method``) against ``pypic_tpu``'s, from the
same seeded numpy inputs: JAX's Pallas kernels in interpret mode, the
port's plain kernel versions (the tensors lie on the CPU). The slab
engines' options are in tests/test_torch_options_slab.py, the sheath's in
tests/test_torch_options_sheath.py, the carried magnetized deposit under
data parallelism in tests/test_torch_carried_dp.py.

* the mixers against JAX's on the same (es, eh, k) sequence: every
  iterate within 1e-5 of its largest value, through the singular
  two-history and Anderson(M)'s non-finite fallbacks; JAX's
  test_anderson_m_accelerates_linear_map (tests/test_ops.py:275);
* the implicit step, 3 steps of tests/test_domain.py's two-stream load at
  dt = 1 / wp and 3 Picard passes with each finalize_field under
  Anderson(1) and Anderson(2): test_torch_implicit's limits (positions
  2e-4 cells, velocities 1e-5, fields 1e-4, energies rtol 1e-5, the
  passes equal), each option parting from the plain one; the fallbacks of mean2, map and aitken at
  k <= 2 bit for bit with 'last' (tests/test_engines.py:491, :556);
* every ``deposit_method`` against JAX's ``deposit(method=...)`` and
  ``histogram_add`` (tests/test_ops.py:60): 1e-5 of the largest node, the
  histograms equal, each method the same bits call after call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.engines import implicit as jimplicit
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.ops import accel as jaccel
from pypic_tpu.ops import cic as jcic
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch.engines import implicit
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import accel, cic
from pypic_tpu_torch.runner import run
from test_torch_implicit import _close, _configs, _landau_load


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


def _mixers(mode, jit=True):
    """(JAX's mixer, jitted with k static unless ``jit`` is False, the
    port's)."""
    m = accel.anderson_depth(mode)
    if m is None:
        jmix, tmix = jaccel.anderson2_mix, accel.anderson2_mix
    else:
        def jmix(es, eh, k, aux):
            return jaccel.anderson_m_mix(es, eh, k, aux, m)

        def tmix(es, eh, k, aux):
            return accel.anderson_m_mix(es, eh, k, aux, m)
    return (jax.jit(jmix, static_argnums=2) if jit else jmix), tmix


def _drive(mode, maps, follow=True, jit=True):
    """Feed both packages the same (es, eh_k = map(es, k)) sequence, es
    taken from JAX's output (held at 0 without ``follow``): each step's
    pair of outputs."""
    jmix, tmix = _mixers(mode, jit)
    es = np.zeros(64, np.float32)
    jaux = jaccel.mix_init(jnp.asarray(es), mode)
    taux = accel.mix_init(_t(es), mode)
    pairs = []
    for k, fmap in enumerate(maps):
        eh = fmap(es).astype(np.float32)
        jnext, jaux = jmix(jnp.asarray(es), jnp.asarray(eh), k, jaux)
        tnext, taux = tmix(_t(es), _t(eh), k, taux)
        pairs.append((np.asarray(jnext), tnext.numpy()))
        if follow:
            es = np.asarray(jnext)
    return pairs


def _linear_maps(iters=8, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(64, 64))
    a = 0.9 * q @ np.diag(rng.uniform(-1, 1, 64)) @ np.linalg.inv(q)
    b = rng.normal(size=64)
    return [lambda es, a=a, b=b: a @ es + b] * iters


@pytest.mark.parametrize("mode", ["anderson2", "anderson3", "anderson4",
                                  "anderson5"])
def test_mixers_match_jax(mode):
    for j, t in _drive(mode, _linear_maps()):
        assert np.isfinite(t).all()
        assert _rel(j, t) <= 1e-5


def test_anderson2_singular_history_falls_back_like_jax():
    """Exactly collinear residual differences (residuals 2^-k f0 at es =
    0: each inner product a power of two times one sum, so det is 0 in
    float32 too): the two-history system is singular, and both take the
    Anderson(1) step (JAX run op by op: a compiled reduction may sum in
    another order and leave det a rounding away from 0)."""
    f0 = np.random.default_rng(4).normal(size=64).astype(np.float32)
    maps = [lambda es, k=k: np.float32(0.5 ** k) * f0 for k in range(6)]
    pairs = _drive("anderson2", maps, follow=False, jit=False)
    for j, t in pairs:
        assert _rel(j, t) <= 1e-5
    # the Anderson(1) step at k = 2: gamma = <df1, f>/<df1, df1> = -1
    np.testing.assert_allclose(pairs[2][1], 0.25 * f0 + (0.25 - 0.5) * f0,
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["anderson3", "anderson4"])
def test_non_finite_histories_fall_back_to_the_map(mode):
    """Residuals at 1e30 (Anderson(M)'s guard; JAX's Anderson(2) has
    none): the normal equations overflow, the solve gives non-finite
    coefficients and both packages return the map output."""
    g = np.random.default_rng(5).normal(size=64)
    maps = [lambda es, k=k: (1e30 * (k + 1)) * g for k in range(4)]
    for j, t in _drive(mode, maps):
        assert np.isfinite(t).all()
        assert _rel(j, t) <= 1e-5


def test_anderson_m_accelerates_linear_map():
    """tests/test_ops.py:275 on the port's mixers: depth 5 reaches a far
    smaller residual than the Anderson(1) secant in 25 iterations, and the
    safeguards never emit a non-finite iterate."""
    assert accel.anderson_depth("anderson5") == 5
    assert accel.anderson_depth("anderson2") is None
    assert accel.anderson_depth("none") is None
    rng = np.random.default_rng(0)
    dim = 51
    q = rng.normal(size=(dim, dim))
    a = torch.tensor(0.97 * q @ np.diag(rng.uniform(-1, 1, dim))
                     @ np.linalg.inv(q), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=dim), dtype=torch.float32)

    def iterate(mode, mix, iters=25):
        es = torch.zeros(dim)
        aux = accel.mix_init(es, mode)
        res = None
        for k in range(iters):
            eh = a @ es + b
            res = float(torch.linalg.norm(eh - es))
            es, aux = mix(es, eh, k, aux)
            assert bool(torch.isfinite(es).all()), (mode, k)
        return res

    r1 = iterate("anderson", accel.anderson_mix)
    r5 = iterate("anderson5", lambda es, eh, k, aux:
                 accel.anderson_m_mix(es, eh, k, aux, 5))
    assert r5 < r1 * 1e-2, (r5, r1)


# ---------------------------------------------------------------------------
# the implicit engine
# ---------------------------------------------------------------------------

IMPLICIT_CASES = [(ff, acc) for ff in ("mean2", "map", "aitken")
                  for acc in ("anderson", "anderson2")] + [("last", "anderson2")]
# the two-stream load of tests/test_domain.py at dt = 1 / wp and 3 Picard
# passes: there the options part measurably from 'last' with Anderson(1)
# (3e-4 to 4e-3 of the largest velocity after 3 steps; at dt = 0.1 / wp the
# loop reaches the float32 floor in 3 passes and they agree to an ulp)
TWO_STREAM = dict(tol=1e-30, maxiter=3, picard_init="extrapolate",
                  backend="fused")
TOL_OPTION_EFFECT = 1e-4


@pytest.fixture(scope="module")
def two_stream():
    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = JGridSpec(64, 15.0 * debye, "periodic")
    x, v, params = jinit.initialize_periodic(
        "two-stream", 16_000, density, 1, 0.05, grid, te, te, seed=2)
    return grid, x, v, params


def _two_stream_run(two_stream, pkg, **opts):
    grid, x, v, params = two_stream
    if pkg == "jax":
        cfg = jimplicit.ImplicitConfig(grid, 1.0 / params.wp, params.p2c,
                                       **TWO_STREAM, **opts)
        return jrun(jimplicit.make_step(cfg), jimplicit.init_state(
            x, v, -E_CHARGE, M_ELECTRON, cfg), 3)
    cfg = implicit.ImplicitConfig(GridSpec(grid.ng, grid.length, grid.bc),
                                  1.0 / params.wp, params.p2c, **TWO_STREAM,
                                  **opts)
    return run(implicit.make_step(cfg), implicit.init_state(
        x, v, -E_CHARGE, M_ELECTRON, cfg, device="cpu"), 3)


@pytest.fixture(scope="module")
def plain_option(two_stream):
    """The port's 'last' with Anderson(1): each option must part from it."""
    return _two_stream_run(two_stream, "port", picard_accel="anderson")[0]


@pytest.mark.parametrize("ff, acc", IMPLICIT_CASES)
def test_implicit_option_matches_jax(two_stream, plain_option, ff, acc):
    """3 steps in both packages: positions within 2e-4 cells, velocities
    within 1e-5 and fields within 1e-4 of their largest value, energies
    rtol 1e-5, the passes equal; and the option parts from the plain one
    by more than 1e-4 of the largest velocity."""
    ng = two_stream[0].ng
    jst, jm = _two_stream_run(two_stream, "jax", finalize_field=ff,
                              picard_accel=acc)
    tst, tm = _two_stream_run(two_stream, "port", finalize_field=ff,
                              picard_accel=acc)
    d = np.abs(np.asarray(jst.p, np.float64) - tst.p.numpy())
    assert np.minimum(d, ng - d).max() < 2e-4
    _close(jst.v, tst.v, 1e-5)
    _close(jst.e, tst.e, 1e-4)
    for name in ("field_energy", "kinetic_energy"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-5)
    np.testing.assert_array_equal(tm.picard_iters.numpy(),
                                  np.asarray(jm.picard_iters))
    assert _rel(plain_option.v, tst.v) > TOL_OPTION_EFFECT


@pytest.fixture(scope="module")
def landau():
    return _landau_load(n=4096)


@pytest.mark.parametrize("ff, kw", [
    ("mean2", dict(tol=1e30, picard_init="extrapolate")),  # k == 1
    ("map", dict(tol=1e30, picard_accel="none")),  # k == 1, no mixing
    ("aitken", dict(tol=1e-30, maxiter=2, picard_accel="none")),  # k == 2
])
def test_finalize_field_fallbacks_equal_last(landau, ff, kw):
    """mean2 at one pass has one map output; map and aitken with no mixing
    at k <= 2 are the map output, which is then the last iterate: each bit
    for bit with 'last'."""
    ng, length, x, v, params = landau
    out = []
    for label in ("last", ff):
        _, tcfg_ = _configs(ng, length, params, backend="fused",
                            finalize_field=label, **{"maxiter": 50, **kw})
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg_,
                                 device="cpu")
        out.append(run(implicit.make_step(tcfg_), st, 5))
    (sa, ma), (sb, mb) = out
    assert int(mb.picard_iters.max()) <= 2
    for f in ("p", "v", "e", "j"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f


def test_resident_refuses_finalize_field_like_jax(landau):
    ng, length, x, v, params = landau
    jcfg, tcfg_ = _configs(ng, length, params, finalize_field="aitken")
    jst = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    tst = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, tcfg_, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jimplicit.run_resident(jcfg, jst, 4)
    with pytest.raises(ValueError) as terr:
        implicit.run_resident(tcfg_, tst, 4)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# deposit_method
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("periodic, ng", [(True, 200), (False, 51)])
@pytest.mark.parametrize("method", ["auto", "scatter", "matmul", "pallas"])
def test_deposit_method_matches_jax(method, periodic, ng):
    rng = np.random.default_rng(3)
    n = 4000
    cells = ng if periodic else ng - 1
    p = rng.uniform(0, cells, n).astype(np.float32)
    val = rng.normal(size=n).astype(np.float32)
    ref = jcic.deposit(jnp.asarray(p), jnp.asarray(val), ng,
                       periodic=periodic, method=method)
    got = cic.deposit(_t(p), _t(val), ng, periodic=periodic, method=method)
    assert got.dtype == torch.float32 and got.shape == (ng,)
    assert _rel(ref, got) <= 1e-5
    again = cic.deposit(_t(p), _t(val), ng, periodic=periodic, method=method)
    assert torch.equal(got, again)


@pytest.mark.parametrize("method", ["auto", "scatter", "matmul", "pallas"])
def test_histogram_method_matches_jax(method):
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 100, 5000).astype(np.int32)
    w = (rng.uniform(size=5000) < 0.3).astype(np.float32)
    ref = jcic.histogram_add(jnp.asarray(idx), jnp.asarray(w), 100,
                             method=method)
    got = cic.histogram_add(_t(idx), _t(w), 100, method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_unknown_deposit_method_raises_like_jax():
    p = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="unknown deposit method"):
        jcic.deposit(jnp.asarray(p), jnp.asarray(p), 8, periodic=True,
                     method="nope")
    with pytest.raises(ValueError, match="unknown deposit method"):
        cic.deposit(_t(p), _t(p), 8, periodic=True, method="nope")
