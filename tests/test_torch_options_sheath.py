"""The sheath engines' Anderson(2) and Anderson(M) against
``pypic_tpu``'s: JAX's Pallas kernels in interpret mode, the port's plain
kernel versions, JAX's threefry draws replayed.

* one step of ``engines.sheath`` with 'anderson2' and 'anderson4' on both
  backends from JAX's state after 10 steps: test_torch_sheath's
  single-step limits and its floor-exit allowance
  (``diagnostics.floor_exit_counts_agree``);
* ``parallel.domain_sheath`` with 'anderson2' on 2 gloo ranks against JAX
  on 2 devices: test_torch_domain_sheath's limits.
"""

import dataclasses as dc

import jax
import numpy as np
import pytest

from pypic_tpu.engines import sheath as jsheath
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.parallel import make_mesh
from pypic_tpu.presets import sheath_dd as jsheath_dd
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch import diagnostics, interop
from pypic_tpu_torch.engines import sheath
from pypic_tpu_torch.parallel import spawn
import _torch_ranks
from test_torch_sheath import _rel, _replay, _tcfg_of


@pytest.fixture(scope="module")
def sheath_state():
    pre = jsheath_dd(n=6000, gamma=0.05)
    cfg = dc.replace(pre.config, record_exit_after_step=0,
                     picard_init="extrapolate", picard_accel="anderson")
    st, _ = jrun(jax.jit(jsheath.make_step(cfg)), pre.state, 10)
    return cfg, st


@pytest.mark.parametrize("backend", ["composed", "fused"])
@pytest.mark.parametrize("acc", ["anderson2", "anderson4"])
def test_sheath_accel_step_matches_jax(sheath_state, backend, acc):
    cfg, jst = sheath_state
    jcfg = dc.replace(cfg, picard_accel=acc, backend=backend)
    js1, jm = jax.jit(jsheath.make_step(jcfg))(jst)
    d = {k: np.asarray(getattr(jst, k))
         for k in interop._SHEATH_FIELDS + ("rng",)}
    ts1, tm = sheath.make_step(_tcfg_of(jcfg), reinject_draws=_replay(
        jst, jcfg))(interop.sheath_state_from_numpy(d, "cpu"))
    ok, line = diagnostics.floor_exit_counts_agree(
        jm.picard_iters, jm.picard_residual, tm.picard_iters,
        tm.picard_residual, jst.e, js1.e, tol=jcfg.tol,
        tol_floor=jcfg.tol_floor)
    assert ok, line
    assert int(tm.picard_iters) >= 2
    np.testing.assert_array_equal(ts1.active.numpy(), np.asarray(js1.active))
    act = np.asarray(js1.active) == 1
    np.testing.assert_allclose(ts1.p.numpy()[act], np.asarray(js1.p)[act],
                               rtol=0, atol=1e-5)
    assert _rel(js1.u, ts1.u) <= 1e-6
    for k in ("e", "j"):
        assert _rel(getattr(js1, k), getattr(ts1, k)) <= 1e-5, k
    np.testing.assert_array_equal(ts1.exit_hist.numpy(),
                                  np.asarray(js1.exit_hist))


def test_domain_sheath_anderson2_matches_jax(tmp_path_factory):
    """test_torch_domain_sheath.py's case with Anderson(2): 3 steps on 2
    gloo ranks against JAX on 2 devices, each shard's threefry draws
    replayed; each step's Picard count equal or one pass apart at a floor
    exit, the loss counts within 2 a step, the population kept, nothing
    dropped; the first step's fields within 1e-5 of their largest."""
    import test_torch_domain_sheath as case
    from pypic_tpu import initialize as jinit
    from pypic_tpu.parallel import domain_sheath as jds

    grid = JGridSpec(*case.GRID)
    cfg_kw = dict(case.CFG, picard_accel="anderson2")
    d = jinit.initialize_sheath(case.N, 1e19, 1.0, 0.0, grid, case.TE,
                                case.TE, seed=3)
    cfg = jds.DomainSheathConfig(grid, **cfg_kw)
    mesh = make_mesh(case.S, axis="slabs")
    st = jds.shard_state(jds.init_state(d["x"], d["v"], d["q"], d["m"],
                                        d["species"], cfg, seed=1), mesh, cfg)
    step = jds.make_step(cfg, mesh)
    cap = st.p.shape[0] // case.S
    states, metrics, draws = [case._numpy(st)], [], {}
    for i in range(3):
        draws[i] = case._draws(st.rng, cap, float(grid.num_cells))
        st, m = step(st)
        metrics.append(jax.tree.map(np.asarray, m))
        states.append(case._numpy(st))
    got = spawn.run(case.S, _torch_ranks.sheath_slab_steps, states[0],
                    case.GRID, cfg_kw, 3, draws, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp("dsheath"))
    rows = got[0][0]
    assert got[1][0] == rows
    for i, jm in enumerate(metrics):
        ok, line = diagnostics.floor_exit_counts_agree(
            jm.picard_iters, jm.picard_residual, rows["picard_iters"][i],
            rows["picard_residual"][i], states[i]["e"], states[i + 1]["e"],
            tol=cfg.tol, tol_floor=cfg.tol_floor)
        assert ok, f"step {i}: {line}"
        for k in ("n_lost_left", "n_lost_right"):
            assert abs(rows[k][i] - int(getattr(jm, k))) <= 2, (i, k)
        assert rows["n_active"][i] + rows["n_lost_left"][i] \
            + rows["n_lost_right"][i] == case.N
    assert sum(rows["n_dropped"]) == 0 and max(rows["picard_iters"]) >= 2
    first = case._join([r[2] for r in got])
    for k in ("e", "j"):
        assert _rel(states[1][k], first[k]) <= 1e-5, k
