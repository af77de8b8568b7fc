"""Data parallel: the port's four single-slab engines with ``axis_name`` on
two gloo ranks (``parallel.spawn``, ``tests/_torch_ranks.py dp_run``)
against the port's one-rank run and against ``pypic_tpu``'s single-device
run on the same state (JAX's dp tests, tests/test_parallel.py:32, 69, 392,
tests/test_sheath.py:222, tests/test_magnetized.py:492, 608, 638, 1009).

Every rank reports the same metric rows bit for bit (the sums reach every
rank as one buffer), so the Picard and Newton counts agree across ranks.
The hash sampler's seeds are JAX's (``seed_from_key`` of its key splits,
injected through ``hash_seeds``), and the react_batch table is JAX's
threefry table (``source_draws``): the port's runs draw what JAX draws.

Tolerances: the ranks sum in another order than one device, so the runs
agree to float32 summation order, amplified by each workload's feedback,
at JAX's own dp-versus-single-device tolerances:

* implicit and explicit (two-stream, n = 16,000, 10 steps): field energy
  rtol 1e-4, kinetic energy rtol 1e-5; the implicit Picard counts equal;
* sheath (n = 8,192, gamma 0.05, hash; composed 30 steps, fused 15): the
  active and lost counts equal step for step, field energy rtol 1e-3,
  kinetic energy rtol 1e-4;
* magnetized (tests/test_torch_dataparallel_magnetized.py): phi_max rtol
  5e-4 over the first 10-15 steps (the D-N flux row: the median of the
  equilibrated window, rtol 0.05), the counts within JAX's bounds.
"""

import dataclasses as dc

import jax
import numpy as np
import pytest

from pypic_tpu import initialize as jinit
from pypic_tpu import sources as jsources
from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.engines import explicit as jexp
from pypic_tpu.engines import implicit as jimp
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.engines import sheath as jsheath
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import explicit, implicit, magnetized, sheath
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.parallel import dataparallel, make_mesh, spawn
import _torch_ranks

WORLD = 2
TOL_FE, TOL_KE = 1e-4, 1e-5
TOL_SHEATH_FE, TOL_SHEATH_KE = 1e-3, 1e-4
TOL_PHI = 5e-4


def tcfg(jcfg, cls, **over):
    """The port's config of a JAX config (same fields)."""
    kw = {}
    for f in dc.fields(cls):
        val = getattr(jcfg, f.name)
        if isinstance(val, JGridSpec):
            val = GridSpec(val.ng, val.length, val.bc)
        elif isinstance(val, jmag.SourceSpec):
            val = magnetized.SourceSpec(**dc.asdict(val))
        kw[f.name] = val
    kw.update(over)
    return cls(**kw)


def _numpy(st, fields):
    return {k: np.asarray(getattr(st, k)) for k in fields}


def _jrows(metrics):
    return {k: np.asarray(v) for k, v in metrics._asdict().items()
            if np.asarray(v).ndim == 1}


def _seed(k):
    return int(jsources.seed_from_key(k))


def sheath_seeds(rng, steps):
    """JAX's hash seeds of each step (engines/sheath.py step's splits)."""
    out, key = {}, rng
    for s in range(steps):
        key, ku, kv, kx, kr = jax.random.split(key, 5)
        out[s] = dict(therm_u=_seed(ku), therm_v=_seed(kv), reinj_x=_seed(kx),
                      reinj_v=_seed(kr))
    return out


def magnetized_keys(rng, steps):
    """JAX's source key of each step (engines/magnetized.py step's
    splits)."""
    out, key = [], rng
    for _ in range(steps):
        key, _ion, k_src, _gyro = jax.random.split(key, 4)
        out.append(k_src)
    return out


def two_stream():
    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = JGridSpec(64, 15.0 * debye, "periodic")
    x, v, params = jinit.initialize_periodic(
        "two-stream", 16_000, density, 1, 0.05, grid, te, te, seed=2)
    return grid, x, v, params


def sheath_setup(n=8192, gamma=0.05):
    """tests/test_sheath.py _setup at n, seed 3."""
    density, dt, dx = 1e19, 1e-12, 1e-5
    te = ti = 10.0 * 11600.0
    ng = 51
    length = dx * (ng - 1)
    grid = JGridSpec(ng, length, "dirichlet-dirichlet")
    d = jinit.initialize_sheath(n, density, 1.0, 0.0, grid, te, ti, seed=3)
    cfg = jsheath.SheathConfig(
        grid, dt, length * density / n, kbte=K_BOLTZMANN * te,
        kbti=K_BOLTZMANN * ti, gamma=gamma, exit_hist_vmax=3e6,
        record_exit_after_step=10, rng_sampler="hash")
    st = jsheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg,
                            seed=1)
    return cfg, st


def _implicit_explicit_cases():
    grid, x, v, params = two_stream()
    dt = 0.1 / params.wp
    cases = {}
    for backend in ("fused", "composed"):
        jc = jimp.ImplicitConfig(grid, dt, params.p2c, tol=1e-6, maxiter=40,
                                 backend=backend)
        st = jimp.init_state(x, v, -E_CHARGE, M_ELECTRON, jc)
        _, m = jrun(jimp.make_step(jc), st, 10)
        cases[f"implicit {backend}"] = (
            "implicit", _numpy(st, interop._FIELDS),
            tcfg(jc, implicit.ImplicitConfig, axis_name="particles"), 10,
            None, None, _jrows(m))
        jc = jexp.ExplicitConfig(grid, dt, params.p2c, backend=backend)
        st = jexp.init_state(x, v, -E_CHARGE, M_ELECTRON, jc)
        _, m = jrun(jexp.make_step(jc), st, 10)
        cases[f"explicit {backend}"] = (
            "explicit", _numpy(st, interop._EXPLICIT_FIELDS),
            tcfg(jc, explicit.ExplicitConfig, axis_name="particles"), 10,
            None, None, _jrows(m))
    return cases


def _sheath_cases():
    cases = {}
    jc, st = sheath_setup()
    seeds = sheath_seeds(st.rng, 30)
    for backend, steps in (("composed", 30), ("fused", 15)):
        c = dc.replace(jc, backend=backend)
        _, m = jrun(jsheath.make_step(c), st, steps)
        cases[f"sheath {backend}"] = (
            "sheath", _numpy(st, interop._SHEATH_FIELDS + ("rng",)),
            tcfg(c, sheath.SheathConfig, axis_name="particles"), steps,
            seeds, None, _jrows(m))
    return cases


def run_cases(cases, tmp_dir):
    """Every case: JAX's single-device rows, the port's one-rank rows (in
    this process, a one-rank mesh) and its two-rank rows (one spawn)."""
    jobs = []
    for name, (engine, state, cfg, steps, seeds, draws, _) in cases.items():
        if cfg.__class__ is magnetized.MagnetizedConfig and draws is not None:
            # the replayed threefry table: the port's 'auto' takes it
            cfg = dc.replace(cfg, source_sampler="auto")
        cases[name] = cases[name][:2] + (cfg,) + cases[name][3:]
        jobs.append(("dp_run", dict(engine=engine, state=state, cfg=cfg,
                                    n_steps=steps, seeds=seeds, draws=draws)))
    two = spawn.run(WORLD, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_dir)
    one = [_torch_ranks.dp_run(make_mesh(device="cpu"), **kw)
           for _, kw in jobs]
    out = {}
    for i, (name, case) in enumerate(cases.items()):
        ranks = [r[i][0] for r in two]
        out[name] = dict(jax=case[-1], one=one[i][0], two=ranks[0],
                         ranks=ranks)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases({**_implicit_explicit_cases(), **_sheath_cases()},
                     tmp_path_factory.mktemp("dp"))


def _check_pair(name, ref, got):
    """``got`` against ``ref`` (metric rows) at the case's tolerances."""
    a = lambda r, k: np.asarray(r[k], np.float64)  # noqa: E731
    if name.startswith(("implicit", "explicit")):
        np.testing.assert_allclose(a(got, "field_energy"),
                                   a(ref, "field_energy"), rtol=TOL_FE)
        np.testing.assert_allclose(a(got, "kinetic_energy"),
                                   a(ref, "kinetic_energy"), rtol=TOL_KE)
        if name.startswith("implicit"):
            np.testing.assert_array_equal(a(got, "picard_iters"),
                                          a(ref, "picard_iters"))
    elif name.startswith("sheath"):
        np.testing.assert_array_equal(a(got, "n_active"), a(ref, "n_active"))
        np.testing.assert_array_equal(
            a(got, "n_lost_left") + a(got, "n_lost_right"),
            a(ref, "n_lost_left") + a(ref, "n_lost_right"))
        np.testing.assert_allclose(a(got, "field_energy"),
                                   a(ref, "field_energy"), rtol=TOL_SHEATH_FE)
        np.testing.assert_allclose(a(got, "kinetic_energy"),
                                   a(ref, "kinetic_energy"),
                                   rtol=TOL_SHEATH_KE)
    else:
        act = np.abs(a(got, "n_active") - a(ref, "n_active")).max()
        r1, r2 = a(ref, "n_reactivated"), a(got, "n_reactivated")
        if name.endswith("flux"):
            # the D-N start-up transient (phi_max ~300 V, exponential
            # Boltzmann feedback) amplifies summation-order differences:
            # the equilibrated window's median, as JAX's test
            np.testing.assert_allclose(np.median(a(got, "phi_max")[10:]),
                                       np.median(a(ref, "phi_max")[10:]),
                                       rtol=0.05)
            assert act <= 12 and r2.max() <= 40 and r1.sum() > 0
            assert np.abs(r1 - r2).max() <= 10
            assert abs(r1.sum() - r2.sum()) <= max(8, 0.05 * r1.sum())
            return
        first = 15 if name.endswith("source") else 10
        np.testing.assert_allclose(a(got, "phi_max")[:first],
                                   a(ref, "phi_max")[:first], rtol=TOL_PHI)
        if name.endswith("capped-source"):
            assert act <= 4 and r1.sum() > 0
            assert np.abs(r1 - r2).max() <= 2, (r1, r2)
        else:
            assert act <= 4


CASE_NAMES = ["implicit fused", "implicit composed", "explicit fused",
              "explicit composed", "sheath composed", "sheath fused"]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_two_ranks_match_one_rank(runs, name):
    r = runs[name]
    # the sums reach every rank as one buffer: the same rows, bit for bit,
    # so the same Picard / Newton counts on every rank
    for other in r["ranks"][1:]:
        assert other == r["ranks"][0]
    _check_pair(name, r["one"], r["two"])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_one_rank_matches_jax_single_device(runs, name):
    r = runs[name]
    _check_pair(name, {k: v.tolist() for k, v in r["jax"].items()}, r["one"])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_two_ranks_match_jax_single_device(runs, name):
    r = runs[name]
    _check_pair(name, {k: v.tolist() for k, v in r["jax"].items()}, r["two"])


def test_shard_state_cuts_contiguous_blocks_and_gathers_back():
    """Rank r's block is rows [r k, (r + 1) k) of every per-particle
    field, by name (a grid field with ng == n is not cut); the gather
    joins them in rank order."""
    cfg = sheath.SheathConfig(GridSpec(8, 7e-5, "dirichlet-dirichlet"), 1e-12,
                              1.0, 1.0, 1.0)
    n = 8  # ng == n: the fields must stay whole
    st = sheath.init_state(np.linspace(1e-5, 6e-5, n), np.zeros((n, 3)),
                           np.ones(n), np.ones(n), np.ones(n, np.int32), cfg,
                           device="cpu")
    got = spawn.run(WORLD, _torch_ranks.batch,
                    [("dp_blocks", dict(state=interop.sheath_state_to_numpy(st)))],
                    device="cpu")
    for r, ((p, e, whole_p),) in enumerate(got):
        np.testing.assert_array_equal(p, st.p.numpy()[r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(e, st.e.numpy())
        np.testing.assert_array_equal(whole_p, st.p.numpy())
    assert set(dataparallel.particle_fields(st)) == {
        "p", "u", "vy", "vz", "q", "m", "species", "active"}


def test_data_parallel_step_checks_like_jax():
    cfg = implicit.ImplicitConfig(GridSpec(16, 1.0), 1e-3, 1.0)
    mesh = make_mesh(device="cpu")
    st = implicit.init_state(np.linspace(0.0, 0.9, 8), np.zeros(8), -E_CHARGE,
                             M_ELECTRON, cfg, device="cpu")
    with pytest.raises(ValueError, match="must equal"):
        dataparallel.make_data_parallel_step(implicit.make_step, cfg, mesh,
                                             example_state=st)
    cfg = dc.replace(cfg, axis_name="particles")
    with pytest.raises(ValueError, match="example_state"):
        dataparallel.make_data_parallel_step(implicit.make_step, cfg, mesh)
    step = dataparallel.make_data_parallel_step(implicit.make_step, cfg, mesh,
                                                example_state=st)
    st1, m = step(st)
    ref, m_ref = implicit.make_step(dc.replace(cfg, axis_name=None))(st)
    # one rank: every sum is the identity, the step is the one-device step
    assert np.array_equal(st1.p.numpy(), ref.p.numpy())
    assert float(m.kinetic_energy) == float(m_ref.kinetic_energy)
