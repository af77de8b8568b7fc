"""Data parallel beyond the single-slab steps, on gloo ranks
(``parallel.spawn``, ``tests/_torch_ranks.py``):

* ``domain_implicit`` on a 2 x 2 slabs x replicas mesh (four ranks,
  ``make_mesh2``) against ``pypic_tpu``'s run on ``make_mesh2(2, 2)`` from
  the same global state (tests/test_domain.py:401), both backends, 5
  steps: the Picard, migration, drop and alive counts equal step for step,
  field energy rtol 1e-4 and kinetic energy rtol 1e-5 (the slab tests'
  tolerances);
* a checkpoint resume of a two-rank magnetized run (pic_iead, hash
  sampler), bit-exact on the CPU (tests/test_checkpoint.py:305): rank 0
  writes the whole population, the load cuts it into the ranks' blocks;
* ``run_bca_from_iead`` on two ranks against one (tests/test_bca.py:336):
  the histograms are summed, so both feed the surface model the same wall
  flux; the counts within JAX's bounds;
* the CLI's ``--replicas 2`` on ``domain_implicit``, one slab x two
  replicas (tests/test_io.py:473): rank 0 alone writes, the checkpoint
  loads into the JAX preset's state at replicas 2, and ``--resume`` runs.
"""

import dataclasses as dc
import os

import numpy as np
import pytest

from pypic_tpu import checkpoint as jckpt, presets as jpresets
from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu import initialize as jinit
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.parallel import domain_implicit as jdi, make_mesh2

from pypic_tpu_torch import interop, presets
from pypic_tpu_torch.parallel import make_mesh, spawn
import _torch_ranks

TOL_FE, TOL_KE = 1e-4, 1e-5
COUNTS = ("picard_iters", "n_migrated", "n_dropped", "n_alive",
          "n_halo_clamped")
STEPS = 5


def _jax_2x2(backend):
    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = JGridSpec(64, 15.0 * debye, "periodic")
    x, v, params = jinit.initialize_periodic(
        "two-stream", 16_000, density, 1, 0.05, grid, te, te, seed=2)
    kw = dict(dt=0.1 / params.wp, p2c=params.p2c, num_shards=2, tol=1e-6,
              maxiter=40, halo=4, migrate_cap=2048, dp_axis_name="dp",
              num_replicas=2, backend=backend)
    cfg = jdi.DomainImplicitConfig(grid, **kw)
    mesh = make_mesh2(2, 2, axes=("slabs", "dp"))
    st = jdi.shard_state(jdi.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg),
                         mesh, cfg)
    state0 = {k: np.asarray(getattr(st, k)) for k in
              ("p", "v", "alive", "q", "m", "e", "j", "e_prev", "e_prev2",
               "step")}
    step = jdi.make_step(cfg, mesh)
    rows = {}
    for _ in range(STEPS):
        st, m = step(st)
        for k, val in m._asdict().items():
            rows.setdefault(k, []).append(np.asarray(val).item())
    job = ("replicas", dict(state=state0, grid=(grid.ng, grid.length, grid.bc),
                            cfg=kw, n_steps=STEPS, num_replicas=2))
    return job, rows


@pytest.fixture(scope="module")
def slabs_x_replicas(tmp_path_factory):
    refs, jobs = {}, []
    for backend in ("fused", "composed"):
        job, refs[backend] = _jax_2x2(backend)
        jobs.append(job)
    got = spawn.run(4, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp("r4"))
    return refs, got


@pytest.mark.parametrize("i, backend", [(0, "fused"), (1, "composed")])
def test_slabs_x_replicas_match_jax(slabs_x_replicas, i, backend):
    refs, got = slabs_x_replicas
    ref, rows = refs[backend], got[0][i]
    for rank in got[1:]:  # the sums reach every rank: the same rows
        assert rank[i] == rows
    for k in COUNTS:
        assert rows[k] == ref[k], k
    assert sum(rows["n_migrated"]) > 0 and sum(rows["n_dropped"]) == 0
    assert rows["n_alive"] == [16_000] * STEPS
    np.testing.assert_allclose(rows["field_energy"], ref["field_energy"],
                               rtol=TOL_FE)
    np.testing.assert_allclose(rows["kinetic_energy"], ref["kinetic_energy"],
                               rtol=TOL_KE)


def _bca_cfg(pre):
    return dc.replace(pre.config, impact_buffer_size=0, ionization=False,
                      source_sampler="hash", newton_tol=1e-6,
                      axis_name="particles")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two ranks: the checkpoint round trip, the hybrid BCA
    loop and the --replicas CLI run."""
    tmp = tmp_path_factory.mktemp("dp2")
    mag = presets.pic_iead(n_per_species=400, device="cpu")  # n = 2400
    tmpl = presets.pic_iead(n_per_species=400, seed=9, device="cpu")
    cfg = dc.replace(mag.config, source_sampler="hash", newton_tol=1e-6,
                     axis_name="particles")
    bca = presets.pic_bca_aps(ppc=4, device="cpu")
    bca_job = dict(state=interop.magnetized_state_to_numpy(bca.state),
                   cfg=_bca_cfg(bca), steps=20, seeds=None, per_bca=5)
    out = str(tmp / "cli")
    argv = ["run", "domain_implicit", "--device", "cpu", "--particles", "8192",
            "--shards", "1", "--replicas", "2", "--checkpoint-every", "4",
            "--outdir", out]
    jobs = [("dp_resume", dict(state=interop.magnetized_state_to_numpy(mag.state),
                               template=interop.magnetized_state_to_numpy(tmpl.state),
                               cfg=cfg, path=str(tmp / "dp.npz"), seeds=None,
                               k=3)),
            ("dp_bca", bca_job),
            ("cli", dict(argv=argv + ["--steps", "8", "--clean"]))]
    got = spawn.run(2, _torch_ranks.batch, jobs, device="cpu", tmp_dir=str(tmp))
    one = _torch_ranks.dp_bca(make_mesh(device="cpu"), **bca_job)
    resumed = spawn.run(2, _torch_ranks.cli, argv + ["--steps", "4",
                                                     "--resume"],
                        device="cpu", tmp_dir=str(tmp))
    return got, one, out, resumed


def test_checkpoint_resume_data_parallel_magnetized_bitexact(two_ranks):
    got = two_ranks[0]
    for rank in got:
        a, b, step = rank[0]
        assert step == 3
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # every rank gathered the same whole state
    for k, v in got[0][0][0].items():
        np.testing.assert_array_equal(got[1][0][0][k], v)


def test_bca_iead_two_ranks_match_one(two_ranks):
    got, one = two_ranks[0], two_ranks[1]
    src1, inj1, _, n1 = one
    for rank in got:
        src2, inj2, _, n2 = rank[1]
        assert src1 > 0 and inj1 > 0
        assert abs(src1 - src2) <= max(6, 0.05 * src1)
        assert abs(inj1 - inj2) <= max(6, 0.15 * inj1)
        assert n2 == n1
    assert got[0][1] == got[1][1]  # both ranks drew the same products


def test_cli_replicas_run_and_resume(two_ranks):
    got, _, out, resumed = two_ranks
    wrote0, wrote1 = got[0][2], got[1][2]
    assert wrote1 == [] and wrote0
    import json

    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 4  # the resumed run's rows
    assert all(np.isfinite(r["field_energy"]) for r in rows)
    assert rows[-1]["n_dropped"] == 0 and rows[-1]["n_alive"] == 8192
    assert resumed[1] == []
    # the checkpoint holds JAX's global (S, R, cap_r) layout
    ck = os.path.join(out, "checkpoints", "state_0000000008.npz")
    jpre = jpresets.domain_implicit(n=8192, shards=1, replicas=2)
    jst, manifest = jckpt.load(ck, jpre.state)
    assert manifest["step"] == 8 and int(np.asarray(jst.step)) == 8
    assert int(np.asarray(jst.alive).sum()) == 8192
