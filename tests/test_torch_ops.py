"""The port's grid operators, loaders and fits against pypic_tpu's.

The same numpy inputs go through the JAX function and its
pypic_tpu_torch counterpart; floats are compared at 1e-5 of each output's
largest magnitude, indices and host-side numpy exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pypic_tpu import constants as jconstants
from pypic_tpu import diagnostics as jdiag
from pypic_tpu import initialize as jinit
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.ops import accel as jaccel
from pypic_tpu.ops import cic as jcic
from pypic_tpu.ops import fd as jfd
from pypic_tpu.ops import poisson as jpoisson

from pypic_tpu_torch import constants, diagnostics, initialize, presets
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import accel, cic, cuda_cic, fd, poisson

REL = 1e-5


def _close(ref, got, rel=REL):
    ref = np.asarray(ref, np.float64)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-300))


def _field(ng, seed=0, scale=1e3):
    return (np.random.default_rng(seed).normal(size=ng) * scale).astype(np.float32)


@pytest.mark.parametrize("ng", [16, 200])
def test_smooth_and_grad_periodic(ng):
    f = _field(ng)
    _close(jfd.smooth_periodic(jnp.asarray(f)), fd.smooth_periodic(torch.from_numpy(f)))
    _close(jfd.grad_periodic(jnp.asarray(f), 0.37),
           fd.grad_periodic(torch.from_numpy(f), 0.37))
    assert fd.smooth_periodic(torch.from_numpy(f)).dtype == torch.float32


@pytest.mark.parametrize("ng", [64, 129, 200])
def test_solve_periodic_neutralized(ng):
    rho = (_field(ng, seed=ng) * 1e-9).astype(np.float32)
    dx = 5e-3
    ref = jpoisson.solve_periodic_neutralized(jnp.asarray(rho), dx)
    got = poisson.solve_periodic_neutralized(torch.from_numpy(rho), dx)
    assert got.dtype == torch.float32 and got.shape == (ng,)
    _close(ref, got)


@pytest.mark.parametrize("mode", ["none", "damped", "anderson"])
def test_mix_init_and_mixing(mode):
    ng = 32
    e0 = _field(ng, seed=1)
    jaux = jaccel.mix_init(jnp.asarray(e0), mode)
    taux = accel.mix_init(torch.from_numpy(e0), mode)
    assert len(jaux) == len(taux)
    es_j = jnp.asarray(e0)
    es_t = torch.from_numpy(e0)
    rng = np.random.default_rng(2)
    for k in range(4):
        eh = (e0 + rng.normal(size=ng) * 10.0 / (k + 1)).astype(np.float32)
        if mode == "anderson":
            es_j, jaux = jaccel.anderson_mix(es_j, jnp.asarray(eh), k, jaux)
            es_t, taux = accel.anderson_mix(es_t, torch.from_numpy(eh), k, taux)
        elif mode == "damped":
            es_j, jaux = jaccel.damped_mix(es_j, jnp.asarray(eh), k, jaux)
            es_t, taux = accel.damped_mix(es_t, torch.from_numpy(eh), k, taux)
        else:
            es_j, es_t = jnp.asarray(eh), torch.from_numpy(eh)
        _close(es_j, es_t)
        for a, b in zip(jaux, taux):
            _close(a, b)


def test_anderson_degenerate_secant_is_plain_fixed_point():
    e = torch.ones(8)
    es, aux = accel.anderson_mix(e, 2 * e, 0, accel.mix_init(e, "anderson"))
    # same residual twice: df == 0, gamma falls back to 0
    es2, _ = accel.anderson_mix(e, 2 * e, 1, aux)
    assert torch.equal(es, 2 * e) and torch.equal(es2, 2 * e)
    # 'andersonM' is a mode (ring buffers of M + 1 rows, as JAX's); a name
    # that parses to no depth is not
    g_hist, f_hist = accel.mix_init(e, "anderson7")
    assert g_hist.shape == f_hist.shape == (8, 8)
    with pytest.raises(ValueError):
        accel.mix_init(e, "anderson7x")


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "bounded"])
def test_cic_indices_weights(periodic):
    ng = 50
    cells = ng if periodic else ng - 1
    p = np.random.default_rng(4).uniform(0, cells, 1001).astype(np.float32)
    p[:4] = [0.0, cells - 1e-4, cells, 1.0]
    ref = jcic.cic_indices_weights(jnp.asarray(p), cells, periodic)
    got = cic.cic_indices_weights(torch.from_numpy(p), cells, periodic)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _close(ref[2], got[2])
    _close(ref[3], got[3])
    # a particle at exactly num_cells lands with full weight on the right node
    assert got[0][2] == cells - 1 and got[3][2] == 1.0


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "bounded"])
@pytest.mark.parametrize("method", ["auto", "scatter"])
def test_deposit_plain(periodic, method):
    """'auto': ops.cic.deposit, the dispatching wrapper; 'scatter': the
    plain index_add_ version it runs on CPU tensors."""
    ng = 129
    cells = ng if periodic else ng - 1
    rng = np.random.default_rng(5)
    p = rng.uniform(0, cells, 5000).astype(np.float32)
    p[:2] = [0.0, cells]
    val = rng.normal(size=5000).astype(np.float32)
    ref = jcic.deposit(jnp.asarray(p), jnp.asarray(val), ng, periodic=periodic,
                       method="scatter")
    fn = cic.deposit if method == "auto" else cuda_cic.deposit_plain
    got = fn(torch.from_numpy(p), torch.from_numpy(val), ng, periodic=periodic)
    _close(ref, got, 2e-5)


def test_histogram_add():
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 40, 3000).astype(np.int32)
    val = rng.uniform(size=3000).astype(np.float32)
    ref = jcic.histogram_add(jnp.asarray(idx), jnp.asarray(val), 40,
                             method="scatter")
    got = cic.histogram_add(torch.from_numpy(idx), torch.from_numpy(val), 40)
    _close(ref, got)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "bounded"])
def test_gather(periodic):
    ng = 51
    cells = ng if periodic else ng - 1
    rng = np.random.default_rng(8)
    p = rng.uniform(0, cells, 3000).astype(np.float32)
    f = _field(ng, seed=9)
    ref = jcic.gather(jnp.asarray(f), jnp.asarray(p), periodic=periodic,
                      method="take")
    got = cic.gather(torch.from_numpy(f), torch.from_numpy(p), periodic=periodic)
    _close(ref, got)


def test_gather_dispatch_rejects_other_devices_and_dtypes():
    """ops.cic.gather dispatches through cuda_cic.gather: the kernel on a
    CUDA tensor, the plain version on the CPU, and an error otherwise."""
    f = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cic.gather(f, torch.empty(4, device="meta"), periodic=True)
    # float32 and float64 run on the CPU (a float64 state); others raise
    with pytest.raises(TypeError, match="float32"):
        cic.gather(torch.zeros(8, dtype=torch.float16),
                   torch.zeros(4, dtype=torch.float16), periodic=True)
    assert cic.gather(torch.zeros(8, dtype=torch.float64),
                      torch.zeros(4, dtype=torch.float64),
                      periodic=True).dtype == torch.float64


def test_grid_spec_matches():
    for args in [(64, 2.5), (51, 1.0, "dirichlet-dirichlet"),
                 (10, 3.0, "dirichlet-neumann")]:
        j, t = JGridSpec(*args), GridSpec(*args)
        assert (t.ng, t.length, t.bc, t.periodic, t.num_cells, t.dx) == (
            j.ng, j.length, j.bc, j.periodic, j.num_cells, j.dx)
        _close(j.nodes(jnp.float32), t.nodes("cpu", torch.float32))
        assert t.nodes("cpu").dtype == torch.float32
    for bad in [(1, 1.0), (8, 0.0), (8, 1.0, "open")]:
        with pytest.raises(ValueError) as je:
            JGridSpec(*bad)
        with pytest.raises(ValueError) as te:
            GridSpec(*bad)
        assert str(te.value) == str(je.value)
    g = GridSpec(np.int64(8), np.float32(2.0))
    assert type(g.ng) is int and type(g.length) is float


def test_constants_identical():
    names = [k for k in vars(jconstants) if k.isupper()]
    assert names
    for k in names:
        assert getattr(constants, k) == getattr(jconstants, k), k


@pytest.mark.parametrize("system", ["landau-damping", "two-stream", "bump-on-tail"])
def test_loader_gives_the_same_load(system):
    jgrid = JGridSpec(64, 0.3)
    x0, v0, p0 = jinit.initialize_periodic(system, 3000, 1e10, 1, 0.2, jgrid,
                                           1160.0, 1160.0, seed=4)
    x1, v1, p1 = initialize.initialize_periodic(system, 3000, 1e10, 1, 0.2,
                                                GridSpec(64, 0.3), 1160.0,
                                                1160.0, seed=4)
    np.testing.assert_array_equal(x0, x1)
    np.testing.assert_array_equal(v0, v1)
    assert vars(p0) == vars(p1)


def test_fits_match():
    dt = 1e-9
    t = np.arange(300) * dt
    grow = 1e-6 * np.exp(2 * 3e7 * t) + 1e-8
    assert diagnostics.growth_rate_from_energy(grow, dt) == \
        jdiag.growth_rate_from_energy(grow, dt)
    decay = np.exp(-2 * 1e7 * t) * (1.5 + np.cos(2 * 2e8 * t)) + 1e-3
    assert diagnostics.damping_rate_from_peaks(torch.tensor(decay), dt) == \
        jdiag.damping_rate_from_peaks(decay, dt)


# (iters_b, resid_b, ok) against iters_a = [3, 4, 3], resid_a = [5e-10,
# 9.9e-10, 4e-10], tol 1e-9: the equal-count steps put the residual norms
# 4.5e-8 apart, so 2 sigma is 9e-8 (in sqrt of the residual)
_COUNT_CASES = {
    "equal": ([3, 4, 3], [5.01e-10, 9.9e-10, 4.02e-10], True),
    "one pass at the threshold": ([3, 3, 3], [5.01e-10, 9.99e-10, 4.02e-10], True),
    "one pass far below the threshold": ([3, 3, 3], [5.01e-10, 2e-10, 4.02e-10], False),
    "two passes": ([3, 2, 3], [5.01e-10, 9.99e-10, 4.02e-10], False),
    "no equal step to measure the gap": ([4, 3, 4], [4e-10, 9.99e-10, 3e-10], False),
}


@pytest.mark.parametrize("case", list(_COUNT_CASES))
def test_picard_counts_agree(case):
    """Counts may differ only by one pass, at a step where the run that
    stopped first sat within twice the runs' measured residual-norm gap
    below tol."""
    iters_b, resid_b, want = _COUNT_CASES[case]
    ok, lines = diagnostics.picard_counts_agree(
        torch.tensor([3, 4, 3], dtype=torch.int32),
        torch.tensor([5e-10, 9.9e-10, 4e-10]), iters_b, resid_b, 1e-9)
    assert ok is want
    assert lines[0].startswith("sigma")
    assert len(lines) == 1 + sum(a != b for a, b in zip([3, 4, 3], iters_b))


def test_presets_match_reference_defaults():
    for name in ("landau_damping", "two_stream"):
        t = getattr(presets, name)(n=2000, device="cpu")
        from pypic_tpu import presets as jpresets

        j = getattr(jpresets, name)(n=2000)
        assert t.name == j.name and t.meta["system"] == j.meta["system"]
        assert vars(t.meta["params"]) == vars(j.meta["params"])
        assert (t.config.grid.ng, t.config.grid.length, t.config.dt,
                t.config.p2c, t.config.tol, t.config.maxiter) == (
            j.config.grid.ng, j.config.grid.length, j.config.dt,
            j.config.p2c, j.config.tol, j.config.maxiter)
        np.testing.assert_array_equal(t.state.p.numpy(), np.asarray(j.state.p))
        _close(j.state.e, t.state.e, 5e-5)
        st, m = t.make_step()(t.state)
        assert torch.isfinite(st.p).all() and int(m.picard_iters) >= 1
