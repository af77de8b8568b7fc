"""The port's bounded slab sheath engine (``pypic_tpu_torch.parallel.
domain_sheath``) against ``pypic_tpu.parallel.domain_sheath`` on 2 gloo
ranks against 2 of conftest's CPU devices, from the same JAX states with
JAX's own threefry draws replayed through ``make_step(reinject_draws=...)``
(each shard's keys folded with its index, as the JAX step folds them):
one step from the initial state and from the state after 5 steps at the
single-step limits of tests/test_torch_sheath.py, and 10 steps, the
Picard counts compared through ``diagnostics.floor_exit_counts_agree``.
The case records the exit histograms from step 0, runs a thermostat
(gamma 0.1), Anderson(1) and the extrapolated start, so every branch of
the step runs. One spawn carries every job.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import initialize as jinit
from pypic_tpu.constants import K_BOLTZMANN
from pypic_tpu.grid import GridSpec as JGridSpec
from pypic_tpu.parallel import domain_sheath as jds, make_mesh

from pypic_tpu_torch import diagnostics, interop
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.parallel import domain_sheath as tds, mesh as tmesh, spawn
from pypic_tpu_torch.tools import domain as drow
import _torch_ranks

S, NG, N, STEPS, LATER = 2, 56, 4000, 10, 5
TE = 10.0 * 11600.0
GRID = (NG, 1e-5 * (NG - 1), "dirichlet-dirichlet")
CFG = dict(dt=1e-12, p2c=GRID[1] * 1e19 / N, kbte=K_BOLTZMANN * TE,
           kbti=K_BOLTZMANN * TE, num_shards=S, halo=2, migrate_cap=4096,
           exit_hist_vmax=3e6, record_exit_after_step=0, gamma=0.1,
           picard_init="extrapolate", picard_accel="anderson")
_STATE = tuple(f.name for f in dc.fields(tds.DomainSheathState)
               if f.name not in ("rng", "step_host"))


def _numpy(state) -> dict:
    d = {k: np.asarray(getattr(state, k)) for k in _STATE}
    d["rng"] = np.asarray(jax.random.key_data(state.rng)
                          if jnp.issubdtype(state.rng.dtype, jax.dtypes.prng_key)
                          else state.rng)
    return d


def _draws(rng, cap: int, cells: float) -> list:
    """The JAX step's threefry draws (domain_sheath.py:233-264), one dict
    a shard: its keys folded with the shard index."""
    _, k_tu, k_tv, k_rx, k_rv = jax.random.split(rng, 5)
    out = []
    for d in range(S):
        loc = lambda k: jax.random.fold_in(k, d)  # noqa: E731
        out.append({
            "x": np.asarray(jax.random.uniform(loc(k_rx), (cap,), jnp.float32,
                                               0.0, cells)),
            "z": np.asarray(jax.random.normal(loc(k_rv), (cap, 3),
                                              jnp.float32)).T.copy(),
            "u_therm": np.asarray(jax.random.uniform(loc(k_tu), (cap,))),
            "z_therm": np.asarray(jax.random.normal(loc(k_tv), (cap, 3),
                                                    jnp.float32)).T.copy()})
    return out


@pytest.fixture(scope="module")
def jax_run():
    """JAX's S-shard run: the states before each step, each step's
    metrics and draws."""
    grid = JGridSpec(*GRID)
    d = jinit.initialize_sheath(N, 1e19, 1.0, 0.0, grid, TE, TE, seed=3)
    cfg = jds.DomainSheathConfig(grid, **CFG)
    mesh = make_mesh(S, axis="slabs")
    st = jds.shard_state(jds.init_state(d["x"], d["v"], d["q"], d["m"],
                                        d["species"], cfg, seed=1), mesh, cfg)
    step = jds.make_step(cfg, mesh)
    cap = st.p.shape[0] // S
    states, metrics, draws = [], [], {}
    for i in range(STEPS):
        states.append(_numpy(st))
        draws[i] = _draws(st.rng, cap, float(grid.num_cells))
        st, m = step(st)
        metrics.append(jax.tree.map(np.asarray, m))
    states.append(_numpy(st))
    return states, metrics, draws


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    states, _, draws = jax_run
    jobs = [("sheath_slab_steps", dict(state=states[0], grid=GRID, cfg=CFG,
                                       n_steps=STEPS, draws=draws)),
            ("sheath_slab_steps", dict(state=states[LATER], grid=GRID, cfg=CFG,
                                       n_steps=1, draws=draws))]
    got = spawn.run(S, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path_factory.mktemp("sheath_ranks"))
    return got


def _join(parts):
    """The ranks' numpy states joined into JAX's global arrays."""
    particle, slabs, _ = interop._DOMAIN[tds.DomainSheathState]
    out = {k: np.concatenate([p[k] for p in parts]) for k in particle + slabs}
    out["exit_hist"] = parts[0]["exit_hist"]
    return out


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("at", [0, LATER])
def test_one_step_matches_jax(jax_run, port_run, at):
    """One step from the JAX state after ``at`` steps with JAX's draws:
    Picard counts equal or one pass apart at a floor exit, statuses and
    the loss counts equal, active positions within 1e-5 cells, velocities
    within 1e-6 of the largest, e, j and phi within 1e-5 of their largest
    (tests/test_torch_sheath.py's single-step limits), the exit
    histograms equal; every rank reports the same metrics."""
    states, metrics, _ = jax_run
    job = 0 if at == 0 else 1
    ranks = [r[job] for r in port_run]
    rows = ranks[0][0]
    assert all(r[0] == rows for r in ranks)
    jm, ref = metrics[at], states[at + 1]
    got = _join([r[2] for r in ranks])
    ok, line = diagnostics.floor_exit_counts_agree(
        jm.picard_iters, jm.picard_residual, rows["picard_iters"][0],
        rows["picard_residual"][0], states[at]["e"], ref["e"], tol=1e-5,
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
    assert _rel(jm.phi, ranks[0][1][0]) <= 1e-5
    np.testing.assert_array_equal(got["exit_hist"], ref["exit_hist"])
    for k in ("field_energy", "kinetic_energy", "current_bias"):
        np.testing.assert_allclose(rows[k][0], float(getattr(jm, k)),
                                   rtol=1e-4, err_msg=k)


def test_ten_steps_match_jax(jax_run, port_run):
    """Ten steps from JAX's initial state with its draws: each step's
    Picard count equal to JAX's or one pass apart at a floor exit, the
    loss counts within 2 a step, nothing dropped, particles migrated
    across the slab boundary, the population kept (n_active + losses =
    n); the final fields within 1e-3 of their largest (float32 sums in
    other orders, compounded over ten steps)."""
    states, metrics, _ = jax_run
    rows, phis, _, _ = port_run[0][0]
    for i, jm in enumerate(metrics):
        ok, line = diagnostics.floor_exit_counts_agree(
            jm.picard_iters, jm.picard_residual, rows["picard_iters"][i],
            rows["picard_residual"][i], states[i]["e"], states[i + 1]["e"],
            tol=1e-5, tol_floor=0.5)
        assert ok, f"step {i}: {line}"
        for k in ("n_lost_left", "n_lost_right"):
            assert abs(rows[k][i] - int(getattr(jm, k))) <= 2, (i, k)
        assert rows["n_active"][i] + rows["n_lost_left"][i] \
            + rows["n_lost_right"][i] == N
    assert sum(rows["n_dropped"]) == 0
    assert sum(rows["n_migrated"]) > 0
    got = _join([r[0][3] for r in port_run])
    for k in ("e", "j"):
        assert _rel(states[-1][k], got[k]) <= 1e-3, k
    assert _rel(metrics[-1].phi, phis[-1]) <= 1e-3


def test_config_checks_and_gated_options():
    """JAX's checks raise JAX's errors; anderson2 and every deposit_method
    build and step."""
    grid = GridSpec(*GRID)
    jgrid = JGridSpec(*GRID)
    for bad, match in ((dict(num_shards=3), "not divisible"),
                       (dict(halo=30), "too large"),
                       (dict(picard_init="x"), "picard_init")):
        for cls, g in ((tds.DomainSheathConfig, grid),
                       (jds.DomainSheathConfig, jgrid)):
            with pytest.raises(ValueError, match=match):
                cls(g, **{**CFG, **bad})
    mesh = tmesh.SlabMesh(0, 1, torch.device("cpu"))
    row_cfg, row_st = drow.sheath_row(mesh, n=2000, ng=51)
    for opt in (dict(picard_accel="anderson2"), dict(deposit_method="pallas"),
                dict(deposit_method="scatter")):
        st, m = tds.make_step(dc.replace(row_cfg, **opt), mesh)(row_st)
        assert int(st.step) == 1 and int(m.n_dropped) == 0
        assert bool(torch.isfinite(m.phi).all()) and int(m.picard_iters) >= 1
        assert (int(m.n_active) + int(m.n_lost_left) + int(m.n_lost_right)
                == 2000)
    cfg = tds.DomainSheathConfig(grid, **CFG)
    with pytest.raises(ValueError, match="ranks"):
        tds.make_step(cfg, mesh)


def test_needs_a_card_unless_cpu(monkeypatch):
    """The row's mesh and state go to the card unless the caller asks for
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_mesh()
    cfg, st = drow.sheath_row(tmesh.make_mesh(device="cpu"), n=2000, ng=51)
    assert st.p.device.type == "cpu" and cfg.num_shards == 1
    assert int(st.filled.sum()) == 2000 and st.e.shape == (51,)


def test_rank_tagged_reinjection_streams():
    """The re-injection draws of rank r use counters (row, step, j,
    r << 16): tag 0 is the single-device engine's stream, bit for bit, and
    another rank's stream differs."""
    from pypic_tpu_torch.ops import cuda_rng

    n, key, step = 64, (0, 1), 3
    g = torch.Generator().manual_seed(0)
    p, u, vy, vz = (torch.rand(n, generator=g) for _ in range(4))
    act = torch.zeros(n)  # every row re-injects
    sig = torch.ones(n)
    base = cuda_rng.sheath_reinject(key, step, p, u, vy, vz, act, sig,
                                    cells=50.0)
    rank0 = cuda_rng.sheath_reinject(key, step, p, u, vy, vz, act, sig,
                                     cells=50.0, tag=0)
    rank1 = cuda_rng.sheath_reinject(key, step, p, u, vy, vz, act, sig,
                                     cells=50.0, tag=1 << 16)
    for a, b, c in zip(base, rank0, rank1):
        assert torch.equal(a, b)
        assert not torch.equal(a, c)
