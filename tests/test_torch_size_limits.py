"""Grid sizes beyond the card kernels' small modes, on the CPU route,
against pypic_tpu.

The shared-memory, thread-histogram and one-CTA limits of the CUDA
kernels belong to the card: on CPU tensors every wrapper runs its plain
version at any grid size, as the JAX package runs these sizes (its Pallas
Newton pads any ng, pallas_newton.py:266). Here the engines step at sizes
where the card takes a kernel's large mode (the sheath pass and
deposit_det above 1,760 and 1,816 nodes, the carried Boris deposit above
19,370, the Newton kernels above 1,024 rows) on the CPU and agree with
pypic_tpu, and the carried deposit's window frame, which decides its
clamps, is JAX's at every size the card takes; tests/test_torch_cuda.py
holds the kernels on the card. Each tolerance is stated beside its test.
"""

import dataclasses as dc

import jax
import numpy as np
import pytest
import torch

from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.engines import sheath as jsheath
from pypic_tpu.ops import pallas_cic

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import magnetized, sheath
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import cuda_cic, cuda_newton


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


NG_SHEATH = 2001  # above the sheath pass's 1,760 and deposit_det's 1,816


def _sheath_replay(jstate, jcfg):
    """The JAX sheath step's own re-injection draws (threefry) as the
    port's reinject_draws (tests/test_torch_sheath.py's replay)."""
    _, _, _, k_rx, k_rv = jax.random.split(jstate.rng, 5)
    n = jstate.p.shape[0]
    dtype = jstate.p.dtype
    cells = float(jcfg.grid.num_cells)
    z = jax.random.normal(k_rv, (3, n), dtype)
    d = {"x": _t(jax.random.uniform(k_rx, jstate.p.shape, dtype, 0.0, cells)),
         "z": tuple(_t(z[i]) for i in range(3))}
    return lambda step, n_draw: d


def _sheath_step_against_jax(backend: str):
    """One sheath_dd(n = 8000, ng = 2001) step of ``backend`` from the JAX
    state after 2 steps, the JAX draws replayed: equal Picard counts and
    statuses, active positions within 1e-5 cells, u within 1e-6 and e, j
    and phi within 1e-5 of their largest (tests/test_torch_sheath.py's
    single-step limits); nothing launched."""
    jpre = jpresets.sheath_dd(n=8000, ng=NG_SHEATH)
    jcfg = dc.replace(jpre.config, backend=backend)
    step = jax.jit(jsheath.make_step(jcfg))
    jst = jpre.state
    for _ in range(2):
        jst, _ = step(jst)
    js1, jm = step(jst)
    d = {k: np.asarray(getattr(jst, k)) for k in interop._SHEATH_FIELDS + ("rng",)}
    tcfg = sheath.SheathConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dc.fields(jcfg) if f.name != "grid"},
                               grid=GridSpec(NG_SHEATH, jcfg.grid.length,
                                             jcfg.grid.bc))
    before = dict(cuda_cic.LAUNCHES)
    ts1, tm = sheath.make_step(tcfg, reinject_draws=_sheath_replay(jst, jcfg))(
        interop.sheath_state_from_numpy(d, "cpu"))
    assert cuda_cic.LAUNCHES == before
    assert int(tm.picard_iters) == int(jm.picard_iters)
    np.testing.assert_array_equal(ts1.active.numpy(), np.asarray(js1.active))
    act = np.asarray(js1.active) == 1
    np.testing.assert_allclose(ts1.p.numpy()[act], np.asarray(js1.p)[act],
                               rtol=0, atol=1e-5)
    assert _rel(js1.u, ts1.u) <= 1e-6
    for k in ("e", "j"):
        assert _rel(getattr(js1, k), getattr(ts1, k)) <= 1e-5, k
    assert _rel(jm.phi, tm.phi) <= 1e-5
    np.testing.assert_array_equal(ts1.exit_hist.numpy(), np.asarray(js1.exit_hist))
    assert ts1.e.shape == (NG_SHEATH,)


def test_sheath_step_beyond_the_card_matches_jax():
    """The composed backend at ng = 2001 (deposit_det's large mode on the
    card), against JAX's composed step (_sheath_step_against_jax)."""
    _sheath_step_against_jax("composed")


def test_fused_sheath_step_at_ng_2001_matches_jax():
    """The fused backend at ng = 2001 (the sheath pass's large mode on the
    card; on the CPU the pass's plain version), against JAX's fused step
    (sheath_picard_pallas and sheath_finalize_pallas in interpret mode),
    at the same limits (_sheath_step_against_jax)."""
    _sheath_step_against_jax("fused")


def test_sheath_row_tool_takes_ng():
    """tools/sheath.py's ``--ng``: run_row on the CPU at ng = 2001 keeps
    the row's dx and density (p2c grows with the domain), steps with the
    population kept and launches nothing; ``--ng`` with ``--replay``
    exits with a usage error."""
    from pypic_tpu_torch.tools import sheath as srow

    res, cfg, fin, m = srow.run_row("cpu", steps=2, n=4000, warmup=0, ng=NG_SHEATH)
    assert res["ng"] == cfg.grid.ng == NG_SHEATH and fin.e.shape == (NG_SHEATH,)
    assert cfg.grid.dx == pytest.approx(srow.DX, rel=1e-12)
    assert cfg.p2c == pytest.approx(srow.DX * (NG_SHEATH - 1) * srow.DENSITY / 4000)
    assert bool(((m.n_active + m.n_lost_left + m.n_lost_right) == 4000).all())
    assert res["launches"] == {}
    with pytest.raises(SystemExit):
        srow.main(["--ng", str(NG_SHEATH), "--replay", "1"])


def test_windows_equal_jax_at_large_grids():
    """``cuda_cic.window`` and ``window_sw`` equal JAX's ``_choose_window``
    and ``_choose_window_sw`` from 19,371 nodes (the carried deposit's
    large mode) to LARGE_MAX_NG: every ng up to 20,000, then a sample (the
    rule's cost changes where K = (ng - 1) // stride + 1 steps, so the
    sample takes the steps' both sides for the widths' strides)."""
    top = cuda_cic.LARGE_MAX_NG
    ngs = set(range(19_371, 20_001))
    rng = np.random.default_rng(21)
    ngs |= set(int(x) for x in rng.integers(20_001, top + 1, 2000))
    for stride in (6, 14, 22, 30, 46, 62, 94, 126, 4, 12, 20, 28, 44, 60, 92, 124):
        for k in (1_500, 40_000, top // stride - 1):
            ngs |= {k * stride, k * stride + 1, k * stride + 2}
    ngs |= {32_768, 65_536, 1 << 20, top}
    for ng in sorted(g for g in ngs if 19_371 <= g <= top):
        assert cuda_cic.window(ng) == pallas_cic._choose_window(ng), ng
        assert cuda_cic.window_sw(ng) == pallas_cic._choose_window_sw(ng), ng


NG_MAG = 1200  # above the Newton kernels' 1,024 rows (one CTA)


@pytest.fixture(scope="module")
def mag_pair():
    """pic_iead(n_per_species=500, ng=1200) and JAX's state after one
    step."""
    jpre = jpresets.pic_iead(n_per_species=500, ng=NG_MAG)
    js1, _ = jax.jit(jmag.make_step(jpre.config))(jpre.state)
    return jpre, js1


@pytest.mark.parametrize("newton", ["auto", "pallas"])
def test_magnetized_step_beyond_the_card_matches_jax(mag_pair, newton):
    """One magnetized step at ng = 1200 from JAX's state after one step.
    'auto' is the Thomas route on the CPU (JAX's 'xla'); 'pallas' runs the
    Newton kernel's plain version (above 1,024 rows the partition solve of
    its large path) against boltzmann_dirichlet_pallas in interpret mode.
    The JAX source draws replayed: rho rtol 1e-4, phi rtol 1e-3 (atol
    1e-8), active positions rtol 2e-5 (atol 1e-5), velocities rtol 2e-4
    (atol 1), equal counts (tests/test_magnetized.py:461-489's limits);
    the Newton counts equal on the Thomas route, within one on the
    kernel's plain version (tol 1e-9 sits at the float32 floor,
    test_pallas.py:315-342)."""
    jpre, js1 = mag_pair
    jcfg = dc.replace(jpre.config,
                      newton_backend="xla" if newton == "auto" else newton)
    js2, jm = jmag.make_step(jcfg)(js1)
    _, _, k_src, _ = jax.random.split(js1.rng, 4)
    src = jcfg.source
    n = js1.p.shape[0]
    batch = jsources.sample_source_6d(k_src, n, jcfg.grid, src.ti, src.mass,
                                      vx=src.vx, components=True)
    draws = {k: _t(v) for k, v in batch.items()}
    tcfg = magnetized.MagnetizedConfig(**{
        f.name: getattr(jcfg, f.name) for f in dc.fields(jcfg)
        if f.name not in ("grid", "source", "newton_backend")},
        grid=GridSpec(NG_MAG, jcfg.grid.length, jcfg.grid.bc),
        source=magnetized.SourceSpec(**dc.asdict(src)), newton_backend=newton)
    d = {k: np.asarray(getattr(js1, k)) for k in interop._MAGNETIZED_FIELDS + ("rng",)}
    before = dict(cuda_cic.LAUNCHES)
    thomas = dict(magnetized.THOMAS_SOLVES)
    ts, tm = magnetized.make_step(tcfg, source_draws=lambda s, k: draws)(
        interop.magnetized_state_from_numpy(d, "cpu"))
    assert cuda_cic.LAUNCHES == before
    assert magnetized.THOMAS_SOLVES == thomas  # counted on the card only
    np.testing.assert_allclose(tm.rho.numpy(), np.asarray(jm.rho), rtol=1e-4)
    np.testing.assert_allclose(tm.phi.numpy(), np.asarray(jm.phi), rtol=1e-3,
                               atol=1e-8)
    act = np.asarray(js2.active) == 1
    np.testing.assert_allclose(ts.p.numpy()[act], np.asarray(js2.p)[act],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy()[act], np.asarray(js2.v)[act],
                               rtol=2e-4, atol=1.0)
    assert int(ts.active.sum()) == int(np.asarray(js2.active).sum())
    assert int(tm.n_reactivated) == int(jm.n_reactivated)
    gap = abs(int(tm.newton_iters) - int(jm.newton_iters))
    assert gap == 0 if newton == "auto" else gap <= 1
    assert float(tm.newton_residual) <= jcfg.newton_tol


def test_newton_wrappers_take_any_ng_on_the_cpu():
    """The Newton wrappers on CPU tensors at ng = 1500: the plain versions
    (above 1,024 rows the large path's partition solve; kernel_rows(1500)
    = 1,504, the TPU's padded_rows 2,048), bit-equal to calling them
    directly, no launch."""
    rng = np.random.default_rng(3)
    dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(1500))).clip(1e15)
    n = _t(dens.astype(np.float32))
    before = dict(cuda_cic.LAUNCHES)
    got = cuda_newton.boltzmann_dn(n, 0.9e17, 1.16e5, 2e-5, torch.zeros(1500))
    ref = cuda_newton.boltzmann_dn_plain(n, 0.9e17, 1.16e5, 2e-5, torch.zeros(1500))
    assert torch.equal(got.phi, ref.phi) and float(got.residual) <= 1e-3
    rho = n * 1.602e-19
    got = cuda_newton.boltzmann_dirichlet(rho, 1e17, 1.16e5, 2e-5)
    ref = cuda_newton.boltzmann_dirichlet_plain(rho, 1e17, 1.16e5, 2e-5)
    assert torch.equal(got.phi, ref.phi)
    assert cuda_newton.padded_rows(1500) == 2048
    assert cuda_newton.kernel_rows(1500) == 1504
    assert cuda_cic.LAUNCHES == before

