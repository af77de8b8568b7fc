"""The implicit superstep on 2 slabs x 2 replicas (``make_mesh2``; JAX's
tests/test_domain.py:1044) against ``pypic_tpu``'s on ``make_mesh2(2,
2)``: k = 2, two calls, 4 gloo ranks from JAX's state (the fused backend:
JAX's Pallas kernels in interpret mode, the port's plain kernels). The
replica sums of the slab deposits and the round-count rendezvous of
``migrate`` hold when migration fires on the last micro-step only: the
counts equal JAX's, field energy rtol 1e-4, kinetic rtol 1e-5.
"""

import jax
import numpy as np

from pypic_tpu.parallel import domain_implicit as di, make_mesh2

from pypic_tpu_torch.parallel import spawn
import _torch_ranks
from test_torch_superstep import (N, TOL_FE, TOL_KE, TOLERANT, _jax_state,
                                  problem)  # noqa: F401 (the fixture)


def test_slabs_x_replicas_superstep_matches_jax(problem, tmp_path_factory):
    """2 slabs x 2 replicas, k = 2, two calls, against JAX's superstep on
    make_mesh2(2, 2) (the fused backend: Pallas in interpret mode, the
    port's plain kernels)."""
    kw = dict(backend="fused", halo=8, dp_axis_name="dp", num_replicas=2,
              **TOLERANT)
    mesh = make_mesh2(2, 2, axes=("slabs", "dp"))
    cfg, kw, st, state0, _ = _jax_state(problem, "implicit", 2, kw, mesh)
    sup = jax.jit(di.make_superstep(cfg, mesh, 2))
    ref = {}
    for _ in range(2):
        st, m = sup(st)
        for f, val in m._asdict().items():
            ref.setdefault(f, []).extend(np.asarray(val).tolist())
    grid = problem[0]
    got = spawn.run(4, _torch_ranks.supersteps, "implicit", state0,
                    (grid.ng, grid.length, grid.bc), kw, 2, 2, 2,
                    device="cpu", tmp_dir=tmp_path_factory.mktemp("super4"))
    rows = got[0][0]
    for other in got[1:]:
        assert other[0] == rows
    assert rows["n_alive"] == ref["n_alive"] == [N] * 4
    for f in ("picard_iters", "n_migrated", "n_dropped", "n_halo_clamped"):
        assert rows[f] == ref[f], f
    assert sum(rows["n_migrated"]) > 0
    np.testing.assert_allclose(rows["field_energy"], ref["field_energy"],
                               rtol=TOL_FE)
    np.testing.assert_allclose(rows["kinetic_energy"], ref["kinetic_energy"],
                               rtol=TOL_KE)
