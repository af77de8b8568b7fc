"""The port's bounded slab sheath engine at a global grid the card runs
only in the deterministic deposit's large mode (ng 4,002: 2,001 nodes a slab,
an extended slab above the columns' 1,816 nodes), on 2 gloo ranks against
``pypic_tpu.parallel.domain_sheath`` on 2 of conftest's CPU devices: one
step from the initial state with JAX's own threefry draws replayed, at
tests/test_torch_domain_sheath.py's single-step limits (on the CPU the
ranks run the plain versions).
"""

import numpy as np

from pypic_tpu import initialize as jinit
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.parallel import domain_sheath as jds, make_mesh

from pypic_tpu_torch import diagnostics
from pypic_tpu_torch.parallel import spawn
import _torch_ranks
from test_torch_domain_sheath import CFG, S, TE, _draws, _join, _numpy, _rel

NG, N = 4002, 8000  # 4,001 does not split into 2 slabs (JAX: ng % S == 0)
GRID = (NG, 1e-5 * (NG - 1), "dirichlet-dirichlet")
CFG_LARGE = {**CFG, "p2c": GRID[1] * 1e19 / N}


def test_one_step_at_ng_4002_matches_jax(tmp_path):
    """One step from the initial state with JAX's draws: Picard counts
    equal or one pass apart at a floor exit, statuses and the loss counts
    equal, active positions within 1e-5 cells, velocities within 1e-6 of
    the largest, e, j and phi within 1e-5 of their largest, the exit
    histograms equal; every rank reports the same metrics."""
    grid = JGridSpec(*GRID)
    d = jinit.initialize_sheath(N, 1e19, 1.0, 0.0, grid, TE, TE, seed=3)
    cfg = jds.DomainSheathConfig(grid, **CFG_LARGE)
    mesh = make_mesh(S, axis="slabs")
    st = jds.shard_state(jds.init_state(d["x"], d["v"], d["q"], d["m"],
                                        d["species"], cfg, seed=1), mesh, cfg)
    start = _numpy(st)
    draws = {0: _draws(st.rng, st.p.shape[0] // S, float(grid.num_cells))}
    st1, jm = jds.make_step(cfg, mesh)(st)
    ref = _numpy(st1)
    jobs = [("sheath_slab_steps", dict(state=start, grid=GRID, cfg=CFG_LARGE,
                                       n_steps=1, draws=draws))]
    ranks = [r[0] for r in spawn.run(S, _torch_ranks.batch, jobs, device="cpu",
                                     tmp_dir=tmp_path)]
    rows = ranks[0][0]
    assert all(r[0] == rows for r in ranks)
    got = _join([r[2] for r in ranks])
    ok, line = diagnostics.floor_exit_counts_agree(
        jm.picard_iters, jm.picard_residual, rows["picard_iters"][0],
        rows["picard_residual"][0], start["e"], ref["e"], tol=1e-5,
        tol_floor=0.5)
    assert ok, line
    for k in ("n_active", "n_lost_left", "n_lost_right", "n_dropped",
              "n_halo_clamped", "n_migrated"):
        assert rows[k][0] == int(getattr(jm, k)), k
    for k in ("active", "filled", "species"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    act = ref["filled"] & (ref["active"] == 1)
    np.testing.assert_allclose(got["p"][act], ref["p"][act], rtol=0, atol=1e-5)
    assert _rel(ref["v"], got["v"]) <= 1e-6
    for k in ("e", "j"):
        assert _rel(ref[k], got[k]) <= 1e-5, k
    assert _rel(np.asarray(jm.phi), ranks[0][1][0]) <= 1e-5
    np.testing.assert_array_equal(got["exit_hist"], ref["exit_hist"])
