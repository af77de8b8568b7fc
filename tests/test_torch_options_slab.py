"""``parallel.domain_implicit`` with each ``finalize_field`` and with
'anderson2' against ``pypic_tpu``'s (tests/test_domain.py:1090): the
headline fixed count (tol 1e-30, maxiter 3, extrapolated start, Anderson)
on tests/test_domain.py's two-stream problem at dt = 1 / wp (where the
options part from 'last': tests/test_torch_options.py), halo 12, JAX on 4
CPU devices (its
Pallas kernels in interpret mode), the port on 4 gloo ranks (its plain
kernel versions) and the port's single-device engine: field energy rtol
1e-4, kinetic rtol 1e-5, the passes, migrated, dropped, clamped and alive
counts equal to JAX's step by step. The aitken and anderson2 inner
products are summed over the slabs (``reduce``), so the sharded field
mixes and extrapolates as the global one.
"""

import numpy as np
import pytest

from pypic_tpu.constants import E_CHARGE, M_ELECTRON
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.parallel import domain_implicit as jdi, make_mesh
from pypic_tpu.runner import run as jrun

from pypic_tpu_torch.engines import implicit
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.parallel import spawn
from pypic_tpu_torch.runner import run
import _torch_ranks


DOMAIN_CASES = {
    # name: implicit options (the headline fixed count, as test_domain.py)
    "map": dict(finalize_field="map"),
    "mean2": dict(finalize_field="mean2"),
    "aitken": dict(finalize_field="aitken"),
    "anderson2": dict(picard_accel="anderson2"),
}
DOMAIN_STEPS = 3
# JAX's aitken step on 2 CPU devices under conftest's x64 ends the process
# (a segmentation fault inside XLA); on 4 it runs
DOMAIN_RANKS = 4


def _two_stream():
    from pypic_tpu import initialize as jinit
    from pypic_tpu.constants import EPSILON_0, K_BOLTZMANN

    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = JGridSpec(64, 15.0 * debye, "periodic")
    x, v, params = jinit.initialize_periodic(
        "two-stream", 16_000, density, 1, 0.05, grid, te, te, seed=2)
    return grid, x, v, params


@pytest.fixture(scope="module")
def domain_runs(tmp_path_factory):
    """Each case: JAX on 4 devices, the port on 4 gloo ranks (one spawn)
    and on one device (the single-device engine)."""
    grid, x, v, params = _two_stream()
    mesh = make_mesh(DOMAIN_RANKS, axis="slabs")
    refs, jobs = {}, []
    for name, opt in DOMAIN_CASES.items():
        kw = dict(dt=1.0 / params.wp, p2c=params.p2c,
                  num_shards=DOMAIN_RANKS, halo=12,
                  migrate_cap=2048, tol=1e-30, maxiter=3,
                  picard_init="extrapolate", picard_accel="anderson",
                  backend="fused")
        kw.update(opt)
        cfg = jdi.DomainImplicitConfig(grid, **kw)
        st = jdi.shard_state(jdi.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg),
                             mesh, cfg)
        state0 = {k: np.asarray(getattr(st, k)) for k in
                  ("p", "v", "alive", "q", "m", "e", "j", "e_prev", "e_prev2",
                   "step")}
        _, m = jrun(jdi.make_step(cfg, mesh), st, DOMAIN_STEPS)
        refs[name] = {k: np.asarray(val).tolist()
                      for k, val in m._asdict().items()}
        jobs.append(("steps", dict(engine="implicit", state=state0,
                                   grid=(grid.ng, grid.length, grid.bc),
                                   cfg=kw, n_steps=DOMAIN_STEPS)))
    got = spawn.run(DOMAIN_RANKS, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp("opts4"))
    single = {}
    tgrid = GridSpec(grid.ng, grid.length, grid.bc)
    for name, opt in DOMAIN_CASES.items():
        c1 = implicit.ImplicitConfig(
            tgrid, 1.0 / params.wp, params.p2c, tol=1e-30, maxiter=3,
            picard_init="extrapolate", **{"picard_accel": "anderson", **opt})
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, c1, device="cpu")
        _, m1 = run(implicit.make_step(c1), st, DOMAIN_STEPS)
        single[name] = {k: getattr(m1, k).numpy().tolist()
                        for k in ("field_energy", "kinetic_energy",
                                  "picard_iters")}
    return refs, {name: [r[i][0] for r in got]
                  for i, name in enumerate(DOMAIN_CASES)}, single


@pytest.mark.parametrize("name", sorted(DOMAIN_CASES))
def test_domain_implicit_option_matches_jax(domain_runs, name):
    refs, got, single = domain_runs
    rows, ref = got[name][0], refs[name]
    assert all(other == rows for other in got[name][1:])
    for k in ("picard_iters", "n_migrated", "n_dropped", "n_alive",
              "n_halo_clamped"):
        assert rows[k] == ref[k], k
    assert rows["picard_iters"] == [3] * DOMAIN_STEPS
    assert rows["n_alive"] == [16_000] * DOMAIN_STEPS
    for other in (ref, single[name]):
        np.testing.assert_allclose(rows["field_energy"], other["field_energy"],
                                   rtol=1e-4)
        np.testing.assert_allclose(rows["kinetic_energy"],
                                   other["kinetic_energy"], rtol=1e-5)
