"""The port's slab-sharded magnetized engine (``pypic_tpu_torch.parallel.
domain_magnetized``) and its preset ``pic_iead_dd`` against
``pypic_tpu``'s on conftest's CPU devices, the port on gloo ranks, from
the same JAX states with JAX's own threefry draws replayed through
``make_step(source_draws=..., ion_draws=...)`` (the replicated
re-activation table of each step; each rank's ionization uniforms from
the key folded with its (slab, replica) index):

* the distributed Newton (the chain solve) and the replicated one at 2
  slabs, one step from the initial state and ten steps, with MCC
  ionization and 'capped-source' re-activation in a third case;
* 2 slabs x 2 replicas against JAX's ``make_mesh2(2, 2)`` (4 ranks);
* ``pic_iead_dd``'s states equal to JAX's at load, slab for slab;
* a checkpoint resume bit-exact on the CPU (both slab engines);
* the options JAX refuses raise JAX's errors.

Limits: one step at tests/test_torch_ionization.py's (rho 1e-4, phi 1e-3
of its value, active positions 2e-5 / 1e-5 cells, velocities 2e-4 / 1
m/s, n0 1e-5), the chain solve against JAX's Thomas within the Newton's
tolerance; ten steps phi_max within 1e-3 (JAX's own slab-against-single
limit is 5e-4 over two steps, tests/test_domain.py:757-759) and the
counts within a few rows.
"""

import dataclasses as dc

import jax
import numpy as np
import pytest
import torch

from pypic_tpu import presets as jpresets, sources as jsources
from pypic_tpu.parallel import domain_magnetized as jdm, make_mesh, make_mesh2

from pypic_tpu_torch import interop, presets
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.parallel import (domain_magnetized as tdm,
                                      mesh as tmesh, spawn)
import _torch_ranks

N_PER, NG, STEPS = 100, 64, 10
_STATE = tuple(f.name for f in dc.fields(tdm.DomainMagnetizedState)
               if f.name not in ("rng", "step_host"))
CASES = {
    "distributed": dict(num_shards=2),
    "replicated": dict(num_shards=2, solver="replicated"),
    "ionization": dict(num_shards=2, ionization=True,
                       reactivate="capped-source", source_n=500,
                       react_batch=256),
    "replicas": dict(num_shards=2, dp_axis_name="dp", num_replicas=2),
}


def _pre():
    return jpresets.pic_iead(n_per_species=N_PER, ng=NG)


def _cfg_kw(c1, **kw):
    """tests/test_domain.py:702-716's configuration as keywords (no grid)."""
    base = dict(dt=c1.dt, te=c1.te, b=c1.b, species_z=c1.species_z,
                ionization=c1.ionization, reactivate="source",
                source=dc.asdict(c1.source), react_batch=512,
                iead_energy_max=c1.iead_energy_max, newton_tol=c1.newton_tol,
                newton_maxiter=c1.newton_maxiter, halo=2, migrate_cap=1024)
    base.update(kw)
    return base


def _jax_cfg(c1, kw):
    kw = dict(kw)
    kw["source"] = type(c1.source)(**kw["source"])
    return jdm.DomainMagnetizedConfig(grid=c1.grid, **kw)


def _numpy(state) -> dict:
    d = {k: np.asarray(getattr(state, k)) for k in _STATE}
    d["rng"] = np.asarray(state.rng)
    return d


def _draws(cfg, rng, cap: int, world: int):
    """The JAX step's draws (domain_magnetized.py:410-413, 581-595): the
    replicated table and each (slab, replica) rank's ionization uniforms."""
    _, k_ion, k_src = jax.random.split(rng, 3)
    src = cfg.source
    table = {k: np.asarray(v) for k, v in jsources.sample_source_6d(
        k_src, cfg.react_batch, cfg.grid, src.ti, src.mass, vx=src.vx,
        components=True).items()}
    ions = None
    if cfg.ionization:
        ions = [np.asarray(jax.random.uniform(jax.random.fold_in(k_ion, r),
                                              (cap,))) for r in range(world)]
    return table, ions


def _jax_run(name):
    pre = _pre()
    c1 = pre.config
    kw = _cfg_kw(c1, **CASES[name])
    cfg = _jax_cfg(c1, kw)
    reps = cfg.num_replicas
    mesh = (make_mesh2(2, reps, axes=("slabs", "dp")) if reps > 1
            else make_mesh(2, axis="slabs"))
    st = jdm.shard_state(jdm.init_state(
        np.asarray(pre.state.p) * c1.grid.dx,
        np.stack([pre.state.vx, pre.state.vy, pre.state.vz], -1),
        np.asarray(pre.state.m), np.asarray(pre.state.charge_state),
        np.asarray(pre.state.p2c), np.asarray(pre.state.species_idx), cfg,
        seed=1), mesh, cfg)
    step = jdm.make_step(cfg, mesh)
    world = 2 * reps
    cap = st.p.shape[0] // world
    states, metrics, tables, ions = [], [], {}, {}
    for i in range(STEPS):
        states.append(_numpy(st))
        tables[i], ions[i] = _draws(cfg, st.rng, cap, world)
        st, m = step(st)
        metrics.append(jax.tree.map(np.asarray, m))
    states.append(_numpy(st))
    grid = (c1.grid.ng, c1.grid.length, c1.grid.bc)
    return dict(kw=kw, grid=grid, states=states, metrics=metrics,
                tables=tables, ions=None if not cfg.ionization else ions,
                replicas=reps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs of every case, the port's on 2 ranks (one spawn, the
    three one-slab-a-rank cases) and on 4 (the replicas)."""
    out = {name: _jax_run(name) for name in CASES}

    def job(name):
        r = out[name]
        return ("magnetized_slab_steps", dict(
            state=r["states"][0], grid=r["grid"], cfg=r["kw"],
            n_steps=STEPS, tables=r["tables"], ions=r["ions"],
            replicas=r["replicas"]))

    two = spawn.run(2, _torch_ranks.batch,
                    [job(n) for n in ("distributed", "replicated",
                                      "ionization")],
                    device="cpu", tmp_dir=tmp_path_factory.mktemp("mag2"))
    four = spawn.run(4, _torch_ranks.batch, [job("replicas")], device="cpu",
                     tmp_dir=tmp_path_factory.mktemp("mag4"))
    for i, name in enumerate(("distributed", "replicated", "ionization")):
        out[name]["port"] = [r[i] for r in two]
    out["replicas"]["port"] = [r[0] for r in four]
    return out


def _join(parts, replicas=1):
    particle, slabs, _ = interop._DOMAIN[tdm.DomainMagnetizedState]
    out = {k: np.concatenate([p[k] for p in parts]) for k in particle}
    out.update({k: np.concatenate([p[k] for p in parts[::replicas]])
                for k in slabs})
    for k in ("n0", "added", "iead", "p_old"):
        out[k] = parts[0][k]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_one_step_matches_jax(runs, name):
    """One step from JAX's initial state with its draws: rho and phi,
    positions, velocities, n0, the ledger, statuses and histograms, and
    the counts; every rank reports the same metrics."""
    r = runs[name]
    ranks = r["port"]
    rows, phis = ranks[0][0], ranks[0][1]
    assert all(p[0] == rows for p in ranks)
    jm, ref = r["metrics"][0], r["states"][1]
    got = _join([p[2] for p in ranks], r["replicas"])
    np.testing.assert_allclose(phis[0], jm.phi, rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(rows["phi_max"][0], float(jm.phi_max),
                               rtol=1e-5)
    for k in ("active", "species_idx", "from_wall", "at_wall", "filled"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    act = ref["filled"] & (ref["active"] == 1)
    np.testing.assert_allclose(got["p"][act], ref["p"][act], rtol=2e-5,
                               atol=1e-5)
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(got[k][act], ref[k][act], rtol=2e-4,
                                   atol=1.0, err_msg=k)
    np.testing.assert_allclose(got["n0"], ref["n0"], rtol=1e-5)
    np.testing.assert_allclose(got["added"], ref["added"], rtol=1e-6)
    np.testing.assert_array_equal(got["iead"], ref["iead"])
    for k in ("n_active", "n_hit_wall", "n_ionized", "n_reactivated",
              "n_dropped", "n_migrated"):
        assert rows[k][0] == int(getattr(jm, k)), k


@pytest.mark.parametrize("name", list(CASES))
def test_ten_steps_match_jax(runs, name):
    """Ten steps: phi_max within 1e-3 and n0 within 1e-4 each step,
    n_active within 2, nothing dropped, the Newton counts within one (the
    float32 floor: tol 1e-9), the last phi within 1e-3 of its largest;
    particles migrated between the slabs."""
    r = runs[name]
    rows, phis = r["port"][0][0], r["port"][0][1]
    for i, jm in enumerate(r["metrics"]):
        np.testing.assert_allclose(rows["phi_max"][i], float(jm.phi_max),
                                   rtol=1e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(rows["n0"][i], float(jm.n0), rtol=1e-4)
        assert abs(rows["n_active"][i] - int(jm.n_active)) <= 2, i
        assert abs(rows["newton_iters"][i] - int(jm.newton_iters)) <= 1, i
    assert sum(rows["n_dropped"]) == 0
    scale = np.abs(r["metrics"][-1].phi).max()
    assert np.abs(phis[-1] - r["metrics"][-1].phi).max() <= 1e-3 * scale
    if name != "replicas":
        assert sum(rows["n_migrated"]) > 0
    if name == "ionization":
        assert sum(rows["n_ionized"]) > 0


def test_pic_iead_dd_states_equal_jax_at_load():
    """The preset's rank states (2 slabs, and 1 slab x 2 replicas) joined
    equal JAX's pic_iead_dd state, leaf for leaf."""
    for shards, reps in ((2, None), (1, 2)):
        jpre = jpresets.pic_iead_dd(n_per_species=50, ng=NG, shards=shards,
                                    replicas=reps)
        ref = _numpy(jpre.state)
        world = shards * (reps or 1)
        if reps:
            meshes = [tmesh.Mesh2(tmesh.SlabMesh(r // reps, shards, _CPU),
                                  tmesh.SlabMesh(r % reps, reps, _CPU),
                                  tmesh.SlabMesh(r, world, _CPU))
                      for r in range(world)]
        else:
            meshes = [tmesh.SlabMesh(r, world, _CPU) for r in range(world)]
        parts = [presets.pic_iead_dd(n_per_species=50, ng=NG, shards=shards,
                                     replicas=reps, mesh=m, device="cpu")
                 for m in meshes]
        cfg = parts[0].config
        assert (cfg.react_batch, cfg.migrate_cap, cfg.halo) == (
            jpre.config.react_batch, jpre.config.migrate_cap, jpre.config.halo)
        got = interop.domain_magnetized_states_to_numpy(
            [p.state for p in parts], reps or 1)
        for k in _STATE:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got["rng"], ref["rng"])


_CPU = torch.device("cpu")


def test_checkpoint_resume_is_bit_exact(runs, tmp_path):
    """k steps, a save in JAX's global layout (rank 0 writes), k more;
    against a load into the initial state and the same k steps: every
    leaf bit for bit on the CPU, both slab engines on 2 ranks; the file
    loads into JAX's template."""
    from pypic_tpu import checkpoint as jckpt

    r = runs["distributed"]
    sheath = _sheath_case()
    jobs = [("slab_resume", dict(engine="magnetized", state=r["states"][0],
                                 grid=r["grid"], cfg=r["kw"],
                                 path=str(tmp_path / "mag.npz"), k=3)),
            ("slab_resume", dict(engine="sheath", state=sheath["state"],
                                 grid=sheath["grid"], cfg=sheath["cfg"],
                                 path=str(tmp_path / "sheath.npz"), k=3))]
    got = spawn.run(2, _torch_ranks.batch, jobs, device="cpu",
                    tmp_dir=tmp_path)
    for job in range(2):
        for rank in got:
            a, b, step = rank[job]
            assert step == 3
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pre = _pre()
    cfg = _jax_cfg(pre.config, r["kw"])
    template = jdm.init_state(
        np.asarray(pre.state.p) * pre.config.grid.dx,
        np.stack([pre.state.vx, pre.state.vy, pre.state.vz], -1),
        np.asarray(pre.state.m), np.asarray(pre.state.charge_state),
        np.asarray(pre.state.p2c), np.asarray(pre.state.species_idx), cfg)
    loaded, manifest = jckpt.load(str(tmp_path / "mag.npz"), template)
    assert manifest["step"] == 3
    assert int(loaded.step) == 3 and loaded.p.shape == template.p.shape


def _sheath_case():
    """A small 2-slab domain_sheath state (JAX's layout) for the resume."""
    from pypic_tpu import initialize as jinit
    from pypic_tpu.constants import K_BOLTZMANN
    from pypic_tpu.grid import GridSpec as JGridSpec
    from pypic_tpu.parallel import domain_sheath as jds

    te, ng, n = 10.0 * 11600.0, 56, 2000
    grid = (ng, 1e-5 * (ng - 1), "dirichlet-dirichlet")
    cfg = dict(dt=1e-12, p2c=grid[1] * 1e19 / n, kbte=K_BOLTZMANN * te,
               kbti=K_BOLTZMANN * te, num_shards=2, gamma=0.1,
               exit_hist_vmax=3e6, record_exit_after_step=0,
               picard_accel="anderson")
    d = jinit.initialize_sheath(n, 1e19, 1.0, 0.0, JGridSpec(*grid), te, te,
                                seed=3)
    st = jds.init_state(d["x"], d["v"], d["q"], d["m"], d["species"],
                        jds.DomainSheathConfig(JGridSpec(*grid), **cfg), seed=1)
    state = {k: np.asarray(getattr(st, k)) for k in (
        "p", "v", "q", "m", "species", "active", "filled", "e", "j", "e_prev",
        "exit_hist", "step", "rng")}
    return dict(state=state, grid=grid, cfg=cfg)


def test_config_gates_raise_jax_errors():
    """What JAX refuses under slab sharding the port refuses with JAX's
    message: D-N walls, react_batch 0, ng not divisible, the replica
    pairing; the guiding-center pusher, the impact buffer and bca_escape
    are no fields of either config."""
    pre = _pre()
    c1 = pre.config
    tgrid = GridSpec(c1.grid.ng, c1.grid.length, c1.grid.bc)
    dn = GridSpec(600, c1.grid.length, "dirichlet-neumann")
    from pypic_tpu.grid import GridSpec as JGridSpec
    jdn = JGridSpec(600, c1.grid.length, "dirichlet-neumann")
    for bad, match in ((dict(react_batch=0), "react_batch"),
                       (dict(num_shards=7), "not divisible"),
                       (dict(num_replicas=2), "dp_axis_name"),
                       (dict(solver="x"), "solver")):
        kw = _cfg_kw(c1, **{"num_shards": 2, **bad})
        with pytest.raises(ValueError, match=match):
            _jax_cfg(c1, kw)
        kw["source"] = tdm.SourceSpec(**kw["source"])
        with pytest.raises(ValueError, match=match):
            tdm.DomainMagnetizedConfig(grid=tgrid, **kw)
    kw = _cfg_kw(c1, num_shards=2)
    with pytest.raises(ValueError, match="dirichlet-dirichlet"):
        jdm.DomainMagnetizedConfig(**{**kw, "grid": jdn,
                                      "source": c1.source})
    with pytest.raises(ValueError, match="dirichlet-dirichlet"):
        tdm.DomainMagnetizedConfig(**{**kw, "grid": dn,
                                      "source": tdm.SourceSpec(**kw["source"])})
    for field in ("pusher", "impact_buffer_size", "bca_escape"):
        for cls, g, src in ((jdm.DomainMagnetizedConfig, c1.grid, c1.source),
                            (tdm.DomainMagnetizedConfig, tgrid,
                             tdm.SourceSpec(**kw["source"]))):
            with pytest.raises(TypeError, match=field):
                cls(**{**kw, "grid": g, "source": src, field: 1})


def test_preset_needs_a_card_unless_cpu(monkeypatch):
    """pic_iead_dd builds its mesh and state on the card unless the caller
    asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        presets.pic_iead_dd(n_per_species=20, ng=NG)
    pre = presets.pic_iead_dd(n_per_species=20, ng=NG, device="cpu")
    assert pre.state.p.device.type == "cpu"
    assert pre.meta["mesh"].world == 1 and pre.config.num_shards == 1


def test_one_rank_chain_solve_matches_the_single_device_newton():
    """At one rank the slab Newton (the chain solve: one tridiag3_chain a
    step, no interface) reproduces the single-device Newton's phi within
    its tolerance on the same densities, and the ten-step run of the slab
    engine the single-device engine's phi_max within 1e-5."""
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.runner import run

    pre = presets.pic_iead(n_per_species=N_PER, ng=NG, device="cpu")
    c1 = dc.replace(pre.config, react_batch=512)
    dd = presets.pic_iead_dd(n_per_species=N_PER, ng=NG, device="cpu",
                             react_batch=512)
    _, m1 = run(magnetized.make_step(c1), pre.state, STEPS)
    _, m2 = run(dd.make_step(), dd.state, STEPS)
    np.testing.assert_allclose(m2.phi_max.numpy(), m1.phi_max.numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(m2.n_active.numpy(), m1.n_active.numpy())
