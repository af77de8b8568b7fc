"""The Newton-Boltzmann solves above 1,024 rows (the large path of
csrc/newton.cu, ops/cuda_newton.py) against pypic_tpu, on the CPU.

Above ``SMALL_MAX_ROWS`` rows the kernels solve each Newton system by the
partition method: thread t of one CTA owns a block of k rows
(``large_split``), the blocks are reduced to their end rows, the
2 x threads end rows solved by the small path's PCR, the inner rows
recovered. The plain versions follow that algorithm (``_partition_solve``)
and are held here to the Pallas kernels in interpret mode (any ng fits
VMEM there), to a float64 dense solve, and through the engines to JAX's
step; the kernels are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 24). Inputs come from numpy
with a seed; each tolerance is stated beside its test.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.parallel import domain_magnetized as jdm, make_mesh
from pypic_tpu.ops.pallas_newton import boltzmann_dirichlet_pallas, boltzmann_dn_pallas

from pypic_tpu_torch import interop, presets
from pypic_tpu_torch.constants import E_CHARGE
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, cuda_newton
from pypic_tpu_torch.parallel import spawn
from pypic_tpu_torch.runner import run

import _torch_ranks
from test_torch_dirichlet_neumann import _assert_step_close, _replay, _tcfg_of
from test_torch_domain_magnetized import _cfg_kw, _draws, _jax_cfg, _join, _numpy

TE, DX = 11600.0 * 10.0, 2e-5
N0_DD, N0_DN = np.float32(1e17), np.float32(0.9e17)


def _density(ng: int, seed: int) -> np.ndarray:
    """tests/test_pallas.py:315-389's number densities: 1e17 m^-3 with 30%
    noise, the pic_iead-like load of tests/test_torch_newton_rows.py."""
    rng = np.random.default_rng(seed)
    return (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15).astype(np.float32)


@pytest.mark.parametrize("rows,k,threads", [
    (1025, 2, 544), (1500, 2, 768), (2048, 2, 1024), (2049, 3, 704),
    (3073, 4, 800), (4096, 4, 1024), (4100, 5, 832), (8000, 8, 1024),
    (16384, 16, 1024), (262144, 256, 1024)])
def test_large_split_from_the_row_count(rows, k, threads):
    """(k, threads) from the row count alone: k = ceil(rows / 1024),
    threads = ceil(rows / k) rounded up to a warp, at most 1,024; the
    system holds every row and solve_rows is its size in the mode
    'single' (the one-CTA large path)."""
    assert cuda_newton.large_split(rows) == (k, threads)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert threads * k >= rows > threads * (k - 1) - 32 * k
    assert cuda_newton.solve_rows(rows, mode="single") == threads * k


def test_large_split_starts_above_the_small_path():
    """At or below SMALL_MAX_ROWS the small path's rows; the split refuses
    them."""
    assert cuda_newton.SMALL_MAX_ROWS == 1024
    assert cuda_newton.solve_rows(1024) == cuda_newton.kernel_rows(1024) == 1024
    assert cuda_newton.solve_rows(601) == 608
    with pytest.raises(ValueError, match="more than 1024"):
        cuda_newton.large_split(1024)
    assert cuda_newton.LARGE_MAX_ROWS >= 262_144


def _chain_system(c: int, kind: str, rng):
    """A (c,) local chain system: 'boltzmann', the slab Newton's Jacobian
    (identity-ish wall rows, -2 - kappa exp(c1 phi) inside, chip_smoke.py
    _chain_system); 'dominant', 4 + |N(0, 1)| on the diagonal with unit
    off-diagonals (the chain is an unpivoted solver for diagonally
    dominant systems, parallel/distributed_poisson.py)."""
    col = np.arange(c, dtype=np.float64)
    if kind == "boltzmann":
        kappa = (300.0 / (c - 1)) ** 2
        expo = np.exp(-3.0 * (2.0 * col / (c - 1) - 1.0) ** 2)
        interior = (col >= 1) & (col <= c - 2)
        d = np.where(interior, -2.0 - kappa * expo, 1.0 - kappa)
        dl = np.where(col >= c - 1, 0.0, 1.0)
        du = np.where(col <= 0, 0.0, 1.0)
    else:
        d = 4.0 + np.abs(rng.standard_normal(c))
        dl = np.ones(c)
        du = np.ones(c)
    f = rng.standard_normal(c)
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (dl, d, du, f))


@pytest.mark.parametrize("kind", ["boltzmann", "dominant"])
@pytest.mark.parametrize("first,last", [(True, True), (True, False),
                                        (False, True), (False, False)])
@pytest.mark.parametrize("c", [1025, 2500])
def test_chain_plain_partition_matches_dense_float64(c, first, last, kind):
    """tridiag3_chain_plain above 1,024 rows (the partition solve) against a
    float64 dense solve of the same float32 system for [f, e_0, e_(c-1)]:
    x and the six interface scalars within 1e-5 of the largest |x| (the
    chain kernel's tolerance against its plain version, chip_smoke.py
    TOL_CHAIN); no launch."""
    dl, d, du, f = _chain_system(c, kind, np.random.default_rng(c + 7))
    before = dict(cuda_cic.LAUNCHES)
    x, g6 = cuda_newton.tridiag3_chain_plain(dl, d, du, f, first=first, last=last)
    assert cuda_newton.tridiag3_chain(dl, d, du, f, first=first, last=last)[0].equal(x)
    assert cuda_cic.LAUNCHES == before
    a = dl.double().numpy().copy()
    cu = du.double().numpy().copy()
    dense = (np.diag(d.double().numpy()) + np.diag(a[1:], -1) + np.diag(cu[:-1], 1))
    rhs = np.zeros((c, 3))
    rhs[:, 0] = f.double().numpy()
    rhs[0, 1] = 1.0
    rhs[c - 1, 2] = 1.0
    ref = np.linalg.solve(dense, rhs).T
    a0 = 0.0 if first else a[0]
    cc = 0.0 if last else cu[-1]
    g_ref = np.array([ref[0, 0], ref[0, -1], a0 * ref[1, 0], a0 * ref[1, -1],
                      cc * ref[2, 0], cc * ref[2, -1]])
    scale = np.abs(ref).max()
    assert x.shape == (3, c)
    assert np.abs(x.double().numpy() - ref).max() <= 1e-5 * scale
    assert np.abs(g6.double().numpy() - g_ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("ng", [1025, 1500, 4100])
def test_boltzmann_dirichlet_large_plain_matches_pallas(ng):
    """The D-D plain version above 1,024 rows (k = 2, 2 and 5) against
    boltzmann_dirichlet_pallas in interpret mode, cold and warm: phi at
    rtol 1e-3 / atol 1e-8 (tests/test_torch_size_limits.py's limits), the
    Newton counts within one (tol 1e-9 sits at the float32 floor); the
    wrapper on CPU tensors is the plain version and launches nothing."""
    rho = E_CHARGE * _density(ng, 11 + ng)
    ref = boltzmann_dirichlet_pallas(jnp.asarray(rho), N0_DD, TE, DX, tol=1e-9)
    before = dict(cuda_cic.LAUNCHES)
    got = cuda_newton.boltzmann_dirichlet(torch.from_numpy(rho), float(N0_DD), TE, DX,
                                          tol=1e-9)
    assert cuda_cic.LAUNCHES == before
    assert got.phi.shape == (ng,) and float(got.residual) <= 1e-9
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(ref.phi), rtol=1e-3, atol=1e-8)
    ref_w = boltzmann_dirichlet_pallas(jnp.asarray(rho), N0_DD, TE, DX, tol=1e-9,
                                       phi0=ref.phi)
    got_w = cuda_newton.boltzmann_dirichlet(torch.from_numpy(rho), float(N0_DD), TE, DX,
                                            tol=1e-9,
                                            phi0=torch.from_numpy(np.array(ref.phi)))
    assert abs(int(got_w.iterations) - int(ref_w.iterations)) <= 1
    np.testing.assert_allclose(got_w.phi.numpy(), np.asarray(ref_w.phi), rtol=1e-3,
                               atol=1e-8)


@pytest.mark.parametrize("ng", [1025, 2049, 3073, 4098])
def test_boltzmann_dn_large_plain_matches_pallas(ng):
    """The D-N plain version above 1,024 rows against boltzmann_dn_pallas in
    interpret mode, cold and warm, at k = 2, 3, 4 and 5: the Neumann row
    ng - 1 falls on a block's first row (1,025; 3,073), on its last
    (2,049) and inside one (4,098), each with a ragged last block; phi at
    rtol 1e-3 / atol 1e-8, the counts within one."""
    n = _density(ng, 13 + ng)
    zero = np.zeros(ng, np.float32)
    ref = boltzmann_dn_pallas(jnp.asarray(n), N0_DN, TE, DX, jnp.asarray(zero))
    got = cuda_newton.boltzmann_dn(torch.from_numpy(n), float(N0_DN), TE, DX,
                                   torch.from_numpy(zero))
    assert float(got.residual) <= 1e-3
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(ref.phi), rtol=1e-3, atol=1e-8)
    ref_w = boltzmann_dn_pallas(jnp.asarray(n), N0_DN, TE, DX, ref.phi)
    got_w = cuda_newton.boltzmann_dn(torch.from_numpy(n), float(N0_DN), TE, DX,
                                     torch.from_numpy(np.array(ref.phi)))
    assert abs(int(got_w.iterations) - int(ref_w.iterations)) <= 1
    np.testing.assert_allclose(got_w.phi.numpy(), np.asarray(ref_w.phi), rtol=1e-3,
                               atol=1e-8)


NG_STEP = 2048  # k = 2 rows a thread, 1,024 threads


def test_magnetized_step_on_the_large_path_matches_jax(monkeypatch):
    """One magnetized step at ng = 2,048 with newton_backend 'pallas' from
    JAX's state after one step: the port's plain partition Newton in the
    one-CTA mode 'single' (forced: the rule takes the cluster mode here,
    tests/test_torch_newton_cluster.py) against
    boltzmann_dirichlet_pallas in interpret mode, the JAX source draws
    replayed; tests/test_torch_size_limits.py's mag_pair limits (rho rtol
    1e-4, phi rtol 1e-3 / atol 1e-8, active positions rtol 2e-5 / atol
    1e-5, velocities rtol 2e-4 / atol 1, equal counts, Newton counts
    within one)."""
    real = cuda_newton.large_shape
    monkeypatch.setattr(cuda_newton, "large_shape",
                        lambda rows, item=4, mode=None, *a, **kw: real(rows, item, "single",
                                                                      *a, **kw))
    jpre = jpresets.pic_iead(n_per_species=500, ng=NG_STEP)
    js1, _ = jax.jit(jmag.make_step(jpre.config))(jpre.state)
    jcfg = dc.replace(jpre.config, newton_backend="pallas")
    js2, jm = jmag.make_step(jcfg)(js1)
    _, _, k_src, _ = jax.random.split(js1.rng, 4)
    src = jcfg.source
    batch = jsources.sample_source_6d(k_src, js1.p.shape[0], jcfg.grid, src.ti,
                                      src.mass, vx=src.vx, components=True)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tcfg = magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source")},
        grid=GridSpec(NG_STEP, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(src)))
    d = {k: np.asarray(getattr(js1, k)) for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    before = dict(cuda_cic.LAUNCHES)
    thomas = dict(magnetized.THOMAS_SOLVES)
    ts, tm = magnetized.make_step(tcfg, source_draws=lambda s, k: draws)(
        interop.magnetized_state_from_numpy(d, "cpu"))
    assert cuda_cic.LAUNCHES == before and magnetized.THOMAS_SOLVES == thomas
    np.testing.assert_allclose(tm.rho.numpy(), np.asarray(jm.rho), rtol=1e-4)
    np.testing.assert_allclose(tm.phi.numpy(), np.asarray(jm.phi), rtol=1e-3, atol=1e-8)
    act = np.asarray(js2.active) == 1
    np.testing.assert_allclose(ts.p.numpy()[act], np.asarray(js2.p)[act], rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy()[act], np.asarray(js2.v)[act], rtol=2e-4,
                               atol=1.0)
    assert int(ts.active.sum()) == int(np.asarray(js2.active).sum())
    assert int(tm.n_reactivated) == int(jm.n_reactivated)
    assert abs(int(tm.newton_iters) - int(jm.newton_iters)) <= 1


NG_SLAB, N_PER_SLAB, SLAB_STEPS = 2560, 200, 2


def test_two_slab_chain_solve_above_1024_rows_matches_one_device():
    """pic_iead_dd on two gloo ranks at ng = 2,560 (c = 1,280 rows a slab:
    each rank's chain solve takes the partition path), solver
    'distributed', against the port's single-device engine on the same
    load and react_batch (its Newton the plain partition solve at 2,560
    rows): the first two steps' phi_max within 5e-4 (JAX's own
    slab-against-single limit, tests/test_domain.py:757-759), the same
    rows on both ranks, nothing dropped."""
    pre = presets.pic_iead(n_per_species=N_PER_SLAB, ng=NG_SLAB, device="cpu")
    react = max(512, pre.state.p.shape[0] // 64)
    cfg1 = dc.replace(pre.config, react_batch=react, newton_backend="pallas")
    _, m1 = run(magnetized.make_step(cfg1), pre.state, SLAB_STEPS)
    ranks = spawn.run(2, _torch_ranks.slab_preset_rows, N_PER_SLAB, NG_SLAB,
                      SLAB_STEPS, device="cpu")
    rows = ranks[0]
    assert ranks[1] == rows
    np.testing.assert_allclose(rows["phi_max"], m1.phi_max.numpy(), rtol=5e-4)
    assert sum(rows["n_dropped"]) == 0
    assert rows["cells_per_shard"] == NG_SLAB // 2 > cuda_newton.SMALL_MAX_ROWS


NG_DN_STEP = 2049  # k = 3 rows a thread; the Neumann row a block's last


def test_dn_magnetized_step_on_the_large_path_matches_jax():
    """One D-N step at ng = 2,049 from JAX's state after one step, backend
    'fused' and newton_backend 'pallas' on both sides: the port's plain
    partition D-N Newton against boltzmann_dn_pallas in interpret mode,
    the JAX flux draws replayed; tests/test_torch_dirichlet_neumann.py's
    step limits (n rtol 1e-4, phi rtol 1e-3 / atol 1e-8, active positions
    rtol 2e-5 / atol 1e-5, velocities rtol 2e-4 / atol 1, equal counts, n0
    rtol 1e-5), the Newton counts within one."""
    jpre = jpresets.dirichlet_neumann_test(n=4000, ng=NG_DN_STEP)
    js1, _ = jax.jit(jmag.make_step(jpre.config))(jpre.state)
    jcfg = dc.replace(jpre.config, backend="fused", newton_backend="pallas")
    js2, jm = jmag.make_step(jcfg)(js1)
    d = {k: np.asarray(getattr(js1, k)) for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    before = dict(cuda_cic.LAUNCHES)
    ts, tm = magnetized.make_step(_tcfg_of(jcfg), source_draws=_replay(jcfg, {1: js1.rng}))(
        interop.magnetized_state_from_numpy(d, "cpu"))
    assert cuda_cic.LAUNCHES == before
    _assert_step_close(js2, jm, ts, tm)
    assert abs(int(tm.newton_iters) - int(jm.newton_iters)) <= 1


def _jax_slab_run(n_per: int, ng: int, steps: int) -> dict:
    """JAX's domain_magnetized pic_iead on 2 slabs of conftest's CPU
    devices (tests/test_torch_domain_magnetized.py's configuration, solver
    'distributed'): the states, metrics and draws of ``steps`` steps."""
    pre = jpresets.pic_iead(n_per_species=n_per, ng=ng)
    c1 = pre.config
    kw = _cfg_kw(c1, num_shards=2)
    cfg = _jax_cfg(c1, kw)
    mesh = make_mesh(2, axis="slabs")
    st = jdm.shard_state(jdm.init_state(
        np.asarray(pre.state.p) * c1.grid.dx,
        np.stack([pre.state.vx, pre.state.vy, pre.state.vz], -1),
        np.asarray(pre.state.m), np.asarray(pre.state.charge_state),
        np.asarray(pre.state.p2c), np.asarray(pre.state.species_idx), cfg,
        seed=1), mesh, cfg)
    step = jdm.make_step(cfg, mesh)
    states, metrics, tables = [], [], {}
    for i in range(steps):
        states.append(_numpy(st))
        tables[i], _ = _draws(cfg, st.rng, st.p.shape[0] // 2, 2)
        st, m = step(st)
        metrics.append(jax.tree.map(np.asarray, m))
    states.append(_numpy(st))
    return dict(kw=kw, grid=(c1.grid.ng, c1.grid.length, c1.grid.bc),
                states=states, metrics=metrics, tables=tables)


def test_two_slab_chain_solve_above_1024_rows_matches_jax(tmp_path):
    """pic_iead_dd's engine on two gloo ranks at ng = 2,560 (c = 1,280 rows
    a slab: each rank's chain solve takes the partition path), solver
    'distributed', against JAX's domain_magnetized on two CPU devices from
    the same state with JAX's draws replayed: one step at
    tests/test_torch_domain_magnetized.py's one-step limits (phi rtol 1e-3
    / atol 1e-8, active positions rtol 2e-5 / atol 1e-5, velocities rtol
    2e-4 / atol 1, statuses and counts equal), then phi_max within 1e-3
    and the Newton counts within one every step, nothing dropped."""
    r = _jax_slab_run(N_PER_SLAB, NG_SLAB, SLAB_STEPS)
    ranks = spawn.run(2, _torch_ranks.magnetized_slab_steps, r["states"][0], r["grid"],
                      r["kw"], SLAB_STEPS, r["tables"], None, device="cpu",
                      tmp_dir=tmp_path)
    rows, phis = ranks[0][0], ranks[0][1]
    assert ranks[1][0] == rows
    jm, ref = r["metrics"][0], r["states"][1]
    got = _join([p[2] for p in ranks])
    np.testing.assert_allclose(phis[0], jm.phi, rtol=1e-3, atol=1e-8)
    for k in ("active", "species_idx", "from_wall", "at_wall", "filled"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    act = ref["filled"] & (ref["active"] == 1)
    np.testing.assert_allclose(got["p"][act], ref["p"][act], rtol=2e-5, atol=1e-5)
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(got[k][act], ref[k][act], rtol=2e-4, atol=1.0,
                                   err_msg=k)
    for k in ("n_active", "n_hit_wall", "n_reactivated", "n_dropped", "n_migrated"):
        assert rows[k][0] == int(getattr(jm, k)), k
    for i, jm in enumerate(r["metrics"]):
        np.testing.assert_allclose(rows["phi_max"][i], float(jm.phi_max), rtol=1e-3,
                                   err_msg=f"step {i}")
        assert abs(rows["newton_iters"][i] - int(jm.newton_iters)) <= 1, i
    assert sum(rows["n_dropped"]) == 0
