"""The double kernels of a float64 state (rows 1-6, and the sheath
engine's: the pass and finalize, deposit_det, the re-injection and the
hash sampler) against their float64 plain versions, on the card. Every test here needs an NVIDIA GPU and skips
without one; the file imports no JAX:

    python -m pytest --noconftest tests/test_torch_float64_cuda.py -q

Inputs as tests/test_torch_cuda.py's (n = 4097, edge positions 0, ng - 1e-4
and ng), in float64, at ng = 64 (the shared mode) and 40,000 (above the
double kernels' ceilings: the global mode). The kernels round each
operation once in double as the plain versions do: positions, velocities
and the gather bit-equal, the deposits within 16 n eps64 of the largest
node (float64 sums in another order), the clamp counts equal. A float64
implicit step on the card stays float64 and agrees with the CPU's. The
sheath kernels at n = 100,003 across their double ceilings (880 nodes
for the pass, 907 for deposit_det): the large mode's current bit-equal
to the two-word plain twin (``cuda_cic.fixed2_sum_plain``); a float64
sheath step on the card against the CPU's, both backends and samplers.
The magnetized engine's double kernels (rows 7-9, 22 and 23) against
their float64 plain versions at the configs[3] and D-N shapes and past
their double ceilings, and a float64 magnetized step on the card against
the CPU's on every route (fused, composed, carried, D-N, GC, axis_name),
the same draws fed to both sides. The explicit engine's double kernels
(rows 13 and 14, both modes of row 14) against their float64 plain
versions, and a float64 explicit step on the card against the CPU's on
every route (one-kernel, two-stage in both modes, composed).
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
from pypic_tpu_torch.engines import implicit
from pypic_tpu_torch.ops import cuda_cic, cuda_sheath
from pypic_tpu_torch.tools import headline

N = 4097
QM, W, DT, DX = -1.7e11, -3.2e-9, 1e-7, 0.05
TOL_SUM = 16 * N * 2.0 ** -52


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(ng, dev, seed=7):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, ng, N)
    v0 = rng.normal(size=N) * 1e5
    ps = rng.uniform(0, ng, N)
    e = rng.normal(size=ng) * 1e3
    edge = np.array([0.0, ng - 1e-4, ng])
    p0[:3] = edge
    ps[:3] = edge
    ps[3:6] = edge
    v0[:3] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (e, ps, p0, v0)]


def _rel(ref, got):
    return float((ref - got).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 40_000])
@pytest.mark.parametrize("name", ["picard_iteration", "picard_iteration_shared",
                                  "picard_finalize_nodep", "picard_finalize"])
def test_double_pass_and_finalize_match_plain(cuda_device, name, ng):
    e, ps, p0, v0 = _inputs(ng, cuda_device)
    kw = dict(qm=QM, dt=DT, dx=DX, **({} if name == "picard_finalize_nodep" else dict(w=W)))
    if name.startswith("picard_iteration"):
        kw["emit_v"] = True
    cuda_cic.reset_launch_counts()
    got = getattr(cuda_cic, name)(e, ps, p0, v0, ng, **kw)
    ref = getattr(cuda_cic, f"{name}_plain")(e.cpu(), ps.cpu(), p0.cpu(), v0.cpu(), ng, **kw)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES[f"{name}_f64"] == 1 and cuda_cic.LAUNCHES[name] == 0
    if name in cuda_cic.CLUSTER_KERNELS:  # rows 1, 2, 14: cluster_launch's mode
        mode = cuda_cic.cluster_launch(name, N, ng, 132, item=8).mode
    else:
        mode = cuda_cic.sweep_launch(name, N, ng, 132, item=8).mode
    assert cuda_cic.LARGE_LAUNCHES.get(f"{name}_f64 {mode}", 0) == (mode != "shared")
    assert all(t.dtype == torch.float64 for t in got if t.dim() == 1)
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    if name != "picard_finalize_nodep":
        assert _rel(ref[2], got[2].cpu()) <= TOL_SUM
    if name == "picard_iteration_shared":
        assert int(got[3]) == int(ref[3])


# the cluster mode of rows 1 and 2 in double, forced at grids whose
# slices cut the rows' node pairs: C = 2 at 40,000, 4 at 65,536 and
# 100,003 (a shorter last slice), 16 (a non-portable cluster) at 262,144
CLUSTER_NGS = [40_000, 65_536, 100_003, 262_144]


@pytest.mark.cuda
@pytest.mark.parametrize("ng", CLUSTER_NGS)
@pytest.mark.parametrize("name", ["picard_iteration", "picard_iteration_shared"])
def test_double_cluster_mode_matches_plain(cuda_device, monkeypatch, name, ng):
    """Rows 1 and 2's double kernels forced into the cluster mode at a
    ragged n = 4097 with rows astride the slices' seams (r S - 1, r S) and
    the grid's (ng - 1, 0): ph and v1 bit-equal to the float64 plain
    version, jh within 16 n eps64 of its largest node, the clamp count
    equal, one cluster-mode launch of the double kernel."""
    import functools

    e, ps, p0, v0 = _inputs(ng, cuda_device)
    c = cuda_cic.cluster_size(name, ng, 8)
    s = -(-ng // c)
    at = torch.tensor([x - 1 + f for x in [r * s for r in range(1, c)] + [ng]
                       for f in (0.25, 0.75)], dtype=torch.float64, device=cuda_device)
    for t in (ps, p0):
        t[6:6 + at.numel()] = at
    monkeypatch.setattr(cuda_cic, "_pass_launch",
                        functools.partial(cuda_cic._pass_launch, mode="cluster"))
    kw = dict(qm=QM, w=W, dt=DT, dx=DX, emit_v=True)
    cuda_cic.reset_launch_counts()
    got = getattr(cuda_cic, name)(e, ps, p0, v0, ng, **kw)
    ref = getattr(cuda_cic, f"{name}_plain")(e.cpu(), ps.cpu(), p0.cpu(), v0.cpu(), ng, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_cic.LARGE_LAUNCHES) == {f"{name}_f64 cluster": 1}
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    assert _rel(ref[2], got[2].cpu()) <= TOL_SUM
    if name == "picard_iteration_shared":
        assert int(got[3]) == int(ref[3])


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [16_384, 65_536])
def test_double_leapfrog_cluster_mode_matches_plain(cuda_device, monkeypatch, ng):
    """Row 14's double kernel forced into the cluster mode at the rule's
    first node (C = 1) and at 65,536 (C = 4) at a ragged n = 4097, rows'
    new positions astride the slices' seams and the wrap: p1 and v1
    bit-equal to the float64 plain version, rho within 16 n eps64 of its
    largest node (and of its twin's), one cluster-mode launch of the
    double kernel."""
    import functools

    e, _, p0, v0 = _inputs(ng, cuda_device)
    c = cuda_cic.cluster_size("leapfrog_gather_push_deposit", ng, 8)
    s = -(-ng // c)
    at = torch.tensor([x - 1 + f for x in [r * s for r in range(1, c)] + [ng]
                       for f in (0.25, 0.75)], dtype=torch.float64, device=cuda_device)
    p0[6:6 + at.numel()] = at
    v0[6:6 + at.numel()] = 0.0
    monkeypatch.setattr(cuda_cic, "_pass_launch",
                        functools.partial(cuda_cic._pass_launch, mode="cluster"))
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    cuda_cic.reset_launch_counts()
    got = cuda_cic.leapfrog_gather_push_deposit(e, p0, v0, **kw)
    ref = cuda_cic.leapfrog_gather_push_deposit_plain(e.cpu(), p0.cpu(), v0.cpu(), **kw)
    twin = cuda_cic.leapfrog_gather_push_deposit_cluster_plain(
        e.cpu(), p0.cpu(), v0.cpu(), mode="cluster", cluster=c, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_cic.LARGE_LAUNCHES) == {"leapfrog_gather_push_deposit_f64 cluster": 1}
    assert all(t.dtype == torch.float64 for t in got)
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    assert _rel(ref[2], got[2].cpu()) <= TOL_SUM
    assert _rel(twin[2], got[2].cpu()) <= TOL_SUM


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 40_000])
@pytest.mark.parametrize("periodic", [True, False])
def test_double_deposit_and_gather_match_plain(cuda_device, ng, periodic):
    e, _, p0, v0 = _inputs(ng, cuda_device)
    pos = p0 if periodic else p0 * ((ng - 1) / ng)
    cuda_cic.reset_launch_counts()
    dep = cuda_cic.deposit(pos, v0 * W, ng, periodic=periodic)
    gat = cuda_cic.gather(e, pos, periodic=periodic)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES["deposit_f64"] == cuda_cic.LAUNCHES["gather_f64"] == 1
    assert dep.dtype == gat.dtype == torch.float64
    assert _rel(cuda_cic.deposit_plain(pos.cpu(), (v0 * W).cpu(), ng, periodic=periodic),
                dep.cpu()) <= TOL_SUM
    assert torch.equal(gat.cpu(), cuda_cic.gather_plain(e.cpu(), pos.cpu(), periodic=periodic))


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, dict(backend="composed"), dict(window_share="shared"),
                                  dict(finalize="converged-deposit")],
                         ids=["fused", "composed", "shared", "converged-deposit"])
def test_float64_implicit_step_card_matches_cpu(cuda_device, over):
    """One conserving float64 step of the headline physics at n = 20,000
    on the card and on the CPU from one state: p within 1e-10 cells, v, e
    and j within 1e-10 of their largest (float64 sums in other orders),
    the same Picard passes, only double kernels launched."""
    from pypic_tpu_torch import interop

    cfg = headline.headline_config(20_000, **over)
    x, v = headline.device_load(20_000, cfg.grid.length, "cpu")
    st = implicit.init_state(x.double(), v.double(), -E_CHARGE, M_ELECTRON, cfg,
                             dtype=torch.float64, device="cpu")
    d = interop.implicit_state_to_numpy(st)
    step = implicit.make_step(cfg)
    c, mc = step(st)
    cuda_cic.reset_launch_counts()
    g, mg = step(interop.implicit_state_from_numpy(d, cuda_device))
    torch.cuda.synchronize()
    assert g.p.dtype == g.e.dtype == g.j.dtype == torch.float64
    assert int(mc.picard_iters) == int(mg.picard_iters)
    launched = {k for k, n in cuda_cic.LAUNCHES.items() if n}
    assert launched and all(k.endswith("_f64") for k in launched), launched
    dp = (c.p - g.p.cpu()).abs()
    assert float(torch.minimum(dp, cfg.grid.ng - dp).max()) <= 1e-10
    for k in ("v", "e", "j"):
        assert _rel(getattr(c, k), getattr(g, k).cpu()) <= 1e-10, k


# ---------------------------------------------------------------------------
# the sheath engine's double kernels (ROADMAP item 19a): the pass and the
# finalize, deposit_det, the re-injection and the hash sampler
# ---------------------------------------------------------------------------

SHEATH_N = 100_003
SHEATH_DT, SHEATH_DX = 1e-12, 1e-5


def _sheath_inputs64(n, ng, seed=11):
    """Bounded rows in float64: electrons and protons, rows at 0 and at
    cells, rows lost in an earlier pass, rows that cross a wall."""
    rng = np.random.default_rng(seed)
    cells = ng - 1.0
    p0 = rng.uniform(0.0, cells, n)
    ps = np.clip(p0 + 0.2 * rng.normal(size=n), -0.5, cells + 0.5)
    ion = rng.uniform(size=n) < 0.5
    qm = np.where(ion, 1.602e-19 / 1.67e-27, -1.602e-19 / 9.11e-31)
    u0 = rng.normal(size=n) * np.where(ion, 3e4, 1.3e6)
    w = np.where(ion, 1.602e-10, -1.602e-10)
    act = np.ones(n)
    p0[:4] = [0.0, cells, 0.0, cells]
    ps[:4] = p0[:4]
    act[4:40:2] = 0.0
    act[5:40:2] = -1.0
    p0[40:60], u0[40:60] = 0.3, -2.5 * SHEATH_DX / SHEATH_DT
    p0[60:80], u0[60:80] = cells - 0.3, 2.5 * SHEATH_DX / SHEATH_DT
    es = rng.normal(size=ng) * 2e4
    return [torch.from_numpy(a) for a in (es, ps, p0, u0, qm, w, act)]


def _twin(pos, vals, act1, w, ng, n):
    """The large mode's current from the two-word plain twin."""
    at, val = cuda_sheath.sheath_deposit_args_plain(pos, vals, act1, w, ng,
                                                    dt=SHEATH_DT, dx=SHEATH_DX)
    nodes, terms = cuda_cic.deposit_terms_plain(at, val, ng, periodic=False)
    return cuda_cic.fixed2_sum_plain(nodes, terms, ng, n)


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [51, 880, 881, 4000, 40_000])
@pytest.mark.parametrize("final", [False, True], ids=["pass", "finalize"])
def test_double_sheath_pass_matches_plain(cuda_device, final, ng):
    """The double pass (finalize) against its float64 plain version: the
    positions, velocities and statuses bit-equal; the current within
    16 n eps64 of its largest node in the small mode (to 880 nodes) and
    bit-equal to the two-word plain twin above it; the same bits from
    call to call; one ``_f64`` launch a call."""
    args = _sheath_inputs64(SHEATH_N, ng)
    kw = dict(dt=SHEATH_DT, dx=SHEATH_DX)
    fn = cuda_sheath.sheath_finalize if final else cuda_sheath.sheath_picard
    plain = cuda_sheath.sheath_finalize_plain if final else cuda_sheath.sheath_picard_plain
    name = "sheath_finalize" if final else "sheath_picard"
    dev_args = [a.to(cuda_device) for a in args]
    cuda_cic.reset_launch_counts()
    got = fn(*dev_args, **kw)
    again = fn(*dev_args, **kw)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES[f"{name}_f64"] == 2 and cuda_cic.LAUNCHES[name] == 0
    large = ng > cuda_sheath.MAX_NG_F64
    assert cuda_cic.LARGE_LAUNCHES.get(f"{name}_f64 fixed", 0) == (2 if large else 0)
    assert all(t.dtype == torch.float64 for t in got)
    ref = plain(*args, **kw)
    for g, r in zip(got[:-1], ref[:-1]):
        assert torch.equal(g.cpu(), r)
    assert torch.equal(got[-1], again[-1])
    x1, u1, xh, uh, _ = cuda_sheath._push_plain(*args[:5], args[6], SHEATH_DT, SHEATH_DX)
    pos, vals = (x1, u1) if final else (xh, uh)
    if large:
        assert torch.equal(got[-1].cpu(), _twin(pos, vals, ref[-2], args[5], ng, SHEATH_N))
    else:
        assert _rel(ref[-1], got[-1].cpu()) <= 16 * SHEATH_N * 2.0 ** -52


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [128, 907, 908, 40_000])
@pytest.mark.parametrize("periodic", [True, False])
def test_double_deposit_det_matches_plain(cuda_device, ng, periodic):
    """The double deterministic deposit: within 16 n eps64 of the float64
    plain deposit to 907 nodes, bit-equal to the two-word twin above; the
    same bits from call to call."""
    rng = np.random.default_rng(ng)
    p = torch.from_numpy(rng.uniform(0.0, ng - 1.0, SHEATH_N))
    v = torch.from_numpy(rng.normal(size=SHEATH_N) * 1e3)
    cuda_cic.reset_launch_counts()
    got = cuda_cic.deposit_det(p.to(cuda_device), v.to(cuda_device), ng, periodic=periodic)
    again = cuda_cic.deposit_det(p.to(cuda_device), v.to(cuda_device), ng,
                                 periodic=periodic)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES["deposit_det_f64"] == 2 and cuda_cic.LAUNCHES["deposit_det"] == 0
    assert got.dtype == torch.float64 and torch.equal(got, again)
    if ng > 907:
        nodes, terms = cuda_cic.deposit_terms_plain(p, v, ng, periodic=periodic)
        assert torch.equal(got.cpu(), cuda_cic.fixed2_sum_plain(nodes, terms, ng, SHEATH_N))
    else:
        ref = cuda_cic.deposit_plain(p, v, ng, periodic=periodic)
        assert _rel(ref, got.cpu()) <= 16 * SHEATH_N * 2.0 ** -52


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_double_reinject_matches_plain(cuda_device, gamma):
    """The double re-injection: positions bit-equal (float32 draws times
    cells), held rows bit-equal to their float64 inputs, the velocities
    within 1e-6 of the largest (libdevice's logf, sinf and cosf against
    the CPU's float64 functions rounded to float32, times the float64
    sigmas)."""
    from pypic_tpu_torch.ops import cuda_rng

    rng = np.random.default_rng(5)
    n = SHEATH_N
    p = torch.from_numpy(rng.uniform(0.0, 50.0, n))
    u, vy, vz = (torch.from_numpy(rng.normal(size=n) * 1e5) for _ in range(3))
    act = torch.from_numpy(rng.choice([1.0, 0.0, -1.0], n, p=[0.8, 0.1, 0.1]))
    sig = torch.from_numpy(np.where(rng.uniform(size=n) < 0.5, 1.3e6, 3.1e4))
    args = (p, u, vy, vz, act, sig)
    cuda_cic.reset_launch_counts()
    got = cuda_rng.sheath_reinject((0, 3), 11, *[a.to(cuda_device) for a in args],
                                   cells=50.0, gamma=gamma)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES["sheath_reinject_f64"] == 1
    assert cuda_cic.LAUNCHES["sheath_reinject"] == 0
    ref = cuda_rng.sheath_reinject_plain((0, 3), 11, *args, cells=50.0, gamma=gamma)
    assert all(t.dtype == torch.float64 for t in got)
    assert torch.equal(got[0].cpu(), ref[0])
    for g, r in zip(got[1:], ref[1:]):
        assert _rel(r, g.cpu()) <= 1e-6
    if gamma == 0.0:
        keep = act == 1.0
        for g, x in zip(got, args[:4]):
            assert torch.equal(g.cpu()[keep], x[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("normals", [False, True])
def test_double_hash_batch_matches_plain(cuda_device, normals):
    """The float64 hash draws: the uniforms bit-equal to the plain
    version's (exact in float64), the normals within 4 float64 ulps of
    each of its values."""
    from pypic_tpu_torch.ops import cuda_rng

    n, streams, off = 200_003, 4, 2**32 - 1000
    cuda_cic.reset_launch_counts()
    got = cuda_rng.hash_batch(77, n, streams, offset=off, normals=normals,
                              device=cuda_device, dtype=torch.float64)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES["hash_batch_f64"] == 1 and cuda_cic.LAUNCHES["hash_batch"] == 0
    ref = cuda_rng.hash_batch_plain(77, n, streams, off, normals, dtype=torch.float64)
    assert got.dtype == torch.float64
    if not normals:
        assert torch.equal(got.cpu(), ref)
    else:
        ulps = (got.cpu() - ref).abs() / torch.from_numpy(np.spacing(ref.abs().numpy()))
        assert float(ulps.max()) <= 4.0, float(ulps.max())


def _sheath_step_pair(cuda_device, cfg, mesh_of=None):
    """One float64 step of ``cfg`` on the card and on the CPU from one
    state three CPU steps in: ((CPU state, metrics), (card state,
    metrics), the card's launches). ``mesh_of(device)``, when given, makes
    each side's one-rank mesh (``cfg.axis_name`` set)."""
    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import sheath
    from pypic_tpu_torch.tools import sheath as row

    def step_on(device):
        mesh = mesh_of(device) if mesh_of else None
        return sheath.make_step(cfg, mesh=mesh)

    _, st = row.state("cpu", 12_000, cfg, dtype=torch.float64)
    step = step_on("cpu")
    for _ in range(3):
        st, _ = step(st)
    d = interop.sheath_state_to_numpy(st)
    c = step(st)
    cuda_cic.reset_launch_counts()
    g = step_on(cuda_device)(interop.sheath_state_from_numpy(d, cuda_device))
    torch.cuda.synchronize()
    return c, g, {k for k, n in cuda_cic.LAUNCHES.items() if n}


def _sheath_pair_agrees(c, g, launched, tight):
    (c, mc), (g, mg) = c, g
    for k in ("p", "u", "vy", "vz", "e", "j", "exit_hist"):
        assert getattr(g, k).dtype == torch.float64, k
    assert launched and all(k.endswith("_f64") for k in launched), launched
    assert int(mc.picard_iters) == int(mg.picard_iters)
    assert torch.equal(c.active, g.active.cpu())
    assert float((c.p - g.p.cpu()).abs().max()) <= (1e-9 if tight else 2e-7)
    for k in ("u", "vy", "vz"):
        assert _rel(getattr(c, k), getattr(g, k).cpu()) <= (1e-10 if tight else 1e-6), k
    for k in ("e", "j"):
        assert _rel(getattr(c, k), getattr(g, k).cpu()) <= (1e-10 if tight else 1e-7), k
    assert torch.equal(c.exit_hist, g.exit_hist.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["auto", "hash"])
@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_float64_sheath_step_card_matches_cpu(cuda_device, backend, sampler):
    """One float64 sheath step (sheath_dd's physics at n = 12,000, gamma
    0.05) on the card and on the CPU from one state three CPU steps in:
    the same statuses and Picard passes, only double kernels launched,
    every field float64; p within 2e-7 cells, e and j within 1e-7 of
    their largest, u, vy and vz within 1e-6 (float64 sums in other
    orders, and the re-injected rows' float32 normals from libdevice
    against the CPU's: 4 float32 ulps of the largest normal times
    sigma dt/dx is 1.7e-7 cells; 3.2e-8 measured); with the hash
    sampler's float64 draws p within 1e-9 cells and the rest within
    1e-10."""
    import dataclasses

    from pypic_tpu_torch.tools import sheath as row

    cfg = dataclasses.replace(row.config(12_000), backend=backend, rng_sampler=sampler,
                              gamma=0.05, exit_hist_vmax=3e6, record_exit_after_step=0)
    _sheath_pair_agrees(*_sheath_step_pair(cuda_device, cfg), tight=sampler == "hash")


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(picard_accel="anderson2"),
                                  dict(picard_accel="anderson4"),
                                  dict(rng_sampler="pallas", picard_init="field"),
                                  dict(axis_name="particles")],
                         ids=["anderson2", "andersonM", "pallas", "axis_name"])
def test_float64_sheath_options_card_matches_cpu(cuda_device, over):
    """The sheath engine's options in float64 on the card against the
    CPU, one fused step as test_float64_sheath_step_card_matches_cpu's:
    Anderson(2) and Anderson(M), the 'pallas' sampler (Philox on the
    card) with picard_init 'field', and ``axis_name`` on a one-rank mesh
    (the 'hash' sampler there, float64 draws)."""
    import dataclasses

    from pypic_tpu_torch.parallel.mesh import make_mesh
    from pypic_tpu_torch.tools import sheath as row

    cfg = dataclasses.replace(row.config(12_000), backend="fused", gamma=0.05,
                              exit_hist_vmax=3e6, record_exit_after_step=0, **over)
    mesh_of = (lambda dev: make_mesh(device=dev)) if "axis_name" in over else None
    tight = "axis_name" in over
    _sheath_pair_agrees(*_sheath_step_pair(cuda_device, cfg, mesh_of), tight=tight)


# ---------------------------------------------------------------------------
# the magnetized engine's double kernels (ROADMAP item 19b)
# ---------------------------------------------------------------------------


def _mag_rows(n, ng, dev, seed=11):
    """Bounded rows in float64: a tenth inactive, rows past both walls,
    velocities of ions at a few eV."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.5, ng - 0.5, n)
    p[:4] = [0.0, ng - 1.0, -0.3, ng - 0.7]
    v = rng.normal(size=(3, n)) * 2e4
    act = ((rng.random(n) < 0.9) & (p >= 0.0) & (p <= ng - 1.0)).astype(np.float64)
    const = rng.integers(1, 6, n) * (0.5 * 1e-10 * E_CHARGE / (10.81 * 1.67262192e-27))
    w = rng.random((2, n)) * act
    e = rng.normal(size=ng) * 1e5
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (e, p, *v, const, act, *w)]
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("n, ng", [(999_996, 600), (50_000, 800), (100_003, 14_529),
                                   (100_003, 65_536)])
def test_double_deposit2_matches_plain(cuda_device, n, ng):
    """Row 7's double kernel (wide, narrow, the large mode past 14,528
    nodes) within 16 n eps64 of its float64 plain version's largest node,
    counted under deposit2_f64 (in the large mode too)."""
    e, p, vx, vy, vz, const, act, wr, wn = _mag_rows(n, ng, cuda_device)
    cuda_cic.reset_launch_counts()
    a, b = cuda_cic.deposit2(p, wr, wn, ng, periodic=False)
    ra, rb = cuda_cic.deposit2_plain(p.cpu(), wr.cpu(), wn.cpu(), ng, periodic=False)
    torch.cuda.synchronize()
    assert a.dtype == torch.float64 and cuda_cic.LAUNCHES["deposit2_f64"] == 1
    assert cuda_cic.LAUNCHES["deposit2"] == 0
    mode = cuda_cic.deposit_launch_shape(n, ng, False, 132, item=8).mode
    assert cuda_cic.LARGE_LAUNCHES.get("deposit2_f64 global", 0) == (mode == "global")
    tol = 16 * n * 2.0 ** -52
    assert _rel(ra, a.cpu()) <= tol and _rel(rb, b.cpu()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [600, 65_536])
@pytest.mark.parametrize("swap", [False, True])
def test_double_boris_push_matches_plain(cuda_device, ng, swap):
    """Row 8's double kernel (shared field, and the global mode past
    29,056 nodes): p1 and the velocities bit-equal to the float64 plain
    version's (one rounding an operation in the same order), inactive
    rows their inputs."""
    e, p, vx, vy, vz, const, act, _, _ = _mag_rows(100_003, ng, cuda_device)
    kw = dict(b=(0.14, 1.99, 0.0), dt_dx=1e-10 / 5e-6, swap_weights=swap)
    got = cuda_cic.boris_gather_push(e, p, vx, vy, vz, const, act, **kw)
    ref = cuda_cic.boris_gather_push_plain(*(t.cpu() for t in (e, p, vx, vy, vz, const,
                                                                act)), **kw)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64 and torch.equal(g.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [600, 20_000, 65_536])
@pytest.mark.parametrize("pad, hot", [(2, 1.0), (0, 40.0)])
def test_double_carried_deposit_matches_plain(cuda_device, ng, pad, hot):
    """Row 9's double kernel (its columns, the field mode past 9,684 nodes,
    the global mode past 28,928): the push bit-equal to the float64 plain
    version's, rho and n within 16 n eps64 of its largest node, and the
    clamps, counted in the window frame from the float64 positions, equal
    (forced with pad 0 and 40x the velocities)."""
    e, p, vx, vy, vz, const, act, wr, wn = _mag_rows(100_003, ng, cuda_device)
    vx, vy, vz = (hot * v for v in (vx, vy, vz))
    kw = dict(b=(0.14, 1.99, 0.0), dt_dx=1e-10 / 5e-6 * 1e3, pad=pad, swap_weights=True)
    cuda_cic.reset_launch_counts()
    got = cuda_cic.boris_gather_push_deposit(e, p, vx, vy, vz, const, act, wr, wn, **kw)
    ref = cuda_cic.boris_gather_push_deposit_plain(
        *(t.cpu() for t in (e, p, vx, vy, vz, const, act, wr, wn)), **kw)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES["boris_gather_push_deposit_f64"] == 1
    for g, r in zip(got[:4], ref[:4]):
        assert torch.equal(g.cpu(), r)
    tol = 16 * 100_003 * 2.0 ** -52
    assert _rel(ref[4], got[4].cpu()) <= tol and _rel(ref[5], got[5].cpu()) <= tol
    assert int(got[6]) == int(ref[6])
    if pad == 0:
        assert int(ref[6]) > 0


def _newton_load(kind, ng, dev):
    """The configs[3] (D-D) or D-N row's first solve on ng nodes, float64:
    (density, n0)."""
    from pypic_tpu_torch.tools import magnetized as row

    pre = row.preset("iead" if kind == "dd" else "dn", dev, 20_000, 50_000, ng)
    cfg, st = pre.config, row.cast_state(pre.state, torch.float64)
    w = st.p2c / cfg.grid.dx
    rho, n = cuda_cic.deposit2(st.p, st.charge_state * E_CHARGE * w, w, ng, periodic=False)
    return cfg, (rho if kind == "dd" else n), 0.9 * torch.mean(n)


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [600, 800, 1024, 1025, 4096, 16_384])
@pytest.mark.parametrize("kind", ["dd", "dn"])
def test_double_newton_matches_plain(cuda_device, kind, ng):
    """Rows 22 and 23's double kernels (the one-CTA path to 1,024 rows,
    the large path of at most 512 threads above) against their float64
    plain versions on the card, at the row's tolerance and over 8
    iterations at tol 0: the same iterations, phi within 1e-12 of its
    largest (the same PCR and partition order; libdevice's exp against
    PyTorch's); counted under the _f64 names."""
    from pypic_tpu_torch.ops import cuda_newton

    cfg, dens, n0 = _newton_load(kind, ng, cuda_device)
    phi0 = torch.zeros(ng, dtype=torch.float64, device=cuda_device)
    for tol, maxiter in ((1e-9, 1000) if kind == "dd" else (1e-3, 100), (0.0, 8)):
        args = (dens, n0, cfg.te, cfg.grid.dx)
        cuda_cic.reset_launch_counts()
        if kind == "dd":
            got = cuda_newton.boltzmann_dirichlet(*args, tol=tol, maxiter=maxiter)
            ref = cuda_newton.boltzmann_dirichlet_plain(*args, tol=tol, maxiter=maxiter)
            name = "boltzmann_dirichlet"
        else:
            got = cuda_newton.boltzmann_dn(*args, phi0, tol=tol, maxiter=maxiter)
            ref = cuda_newton.boltzmann_dn_plain(*args, phi0, tol=tol, maxiter=maxiter)
            name = "boltzmann_dn"
        torch.cuda.synchronize()
        key = f"{name}{'_large' if ng > 1024 else ''}_f64"
        assert cuda_cic.LAUNCHES[key] == 1, key
        assert got.phi.dtype == got.residual.dtype == torch.float64
        assert int(got.iterations) == int(ref.iterations)
        assert _rel(ref.phi, got.phi) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["single", "cluster"])
@pytest.mark.parametrize("ng", [1025, 4096, 16_384])
@pytest.mark.parametrize("kind", ["dd", "dn"])
def test_double_newton_large_modes_match_plain(cuda_device, kind, ng, mode):
    """Rows 22 and 23's double kernels on the large path in each mode
    forced ('single', 'cluster') against their own mode's float64 plain
    version, 8 iterations at tol 0: one launch in that mode, the same
    iterations, phi within 1e-12 of its largest (the same partition order
    in float64; libdevice's exp against PyTorch's)."""
    from pypic_tpu_torch.ops import cuda_newton

    cfg, dens, n0 = _newton_load(kind, ng, cuda_device)
    args, kw = (dens, n0, cfg.te, cfg.grid.dx), dict(tol=0.0, maxiter=8, mode=mode)
    cuda_cic.reset_launch_counts()
    if kind == "dd":
        got = cuda_newton.boltzmann_dirichlet(*args, **kw)
        ref = cuda_newton.boltzmann_dirichlet_plain(*args, **kw)
        name = "boltzmann_dirichlet_large_f64"
    else:
        phi0 = torch.zeros(ng, dtype=torch.float64, device=cuda_device)
        got = cuda_newton.boltzmann_dn(*args, phi0, **kw)
        ref = cuda_newton.boltzmann_dn_plain(*args, phi0, **kw)
        name = "boltzmann_dn_large_f64"
    torch.cuda.synchronize()
    assert dict(cuda_cic.LARGE_LAUNCHES) == {f"{name} {mode}": 1}
    assert got.phi.dtype == torch.float64
    assert int(got.iterations) == int(ref.iterations) == 8
    assert _rel(ref.phi, got.phi) <= 1e-12


# card against CPU, one float64 step: the tolerances (positions in cells,
# the rest relative to the largest): float64 sums in other orders, the
# card's PCR against the CPU's Thomas solve (float64 rounding of the
# solve), measured below 1e-13. The rows re-activated in the step enter
# from float32 draws in float32 on both sides, and the card divides x by
# dx as a reciprocal product (PyTorch's CUDA division by a scalar): 16
# float32 ulps of the largest there (measured 1 ulp of p, 1.1e-7 of v
# on the GC pack), and the carried rho and n may move by those rows'
# position gap times their weights
TOL64_MAG_STEP = {"p": 1e-9, "v": 1e-10, "phi": 1e-12, "rho": 1e-12}
TOL64_REACTIVATED = 16 * 2.0 ** -24
MAG64_ROUTES = {
    "fused": ("iead", dict(backend="fused")),
    "composed": ("iead", dict(backend="composed")),
    "carried": ("iead", dict(carried_deposit="on", react_batch=512)),
    "dn": ("dn", {}),
    "gc": ("gc", {}),
    "axis_name": ("iead", dict(axis_name="particles")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(MAG64_ROUTES))
def test_float64_magnetized_step_card_matches_cpu(cuda_device, route):
    """One float64 magnetized step on the card against the CPU from one
    state three CPU steps in (n = 12,000; the D-N row at 50,000), the
    CPU's source (or flux) and gyro draws fed to both sides: the active
    flags, re-activations, clamps and Newton iterations equal, only double
    kernels launched (the Newton one, not the Thomas route), every field
    float64; p, v, phi and the carried rho and n at TOL64_MAG_STEP."""
    import dataclasses

    from pypic_tpu_torch import interop, sources
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.parallel.mesh import make_mesh
    from pypic_tpu_torch.tools import magnetized as row

    kind, over = MAG64_ROUTES[route]
    pre = row.preset(kind, "cpu", 2000, 12_000)
    cfg = dataclasses.replace(pre.config, **over)
    st = row.cast_state(pre.state, torch.float64)
    if cfg.carried_deposit == "on":
        st = magnetized.prime_carry(st, cfg)

    def hooks(device, state):
        src = cfg.source
        n = cfg.react_batch or state.p.shape[0]

        def draws(step, k):
            if cfg.reactivate == "flux":
                d = sources.sample_flux_batch(state.rng, step, k, cfg.grid, src.ti, src.mass,
                                              vx=src.vx, gamma=cfg.flux_gamma,
                                              vx_pert=cfg.flux_vx_pert, device="cpu")
            else:
                d = sources.sample_source_batch(state.rng, step, n, cfg.grid, src.ti,
                                                src.mass, vx=src.vx, device="cpu")
            return {key: v.to(device) for key, v in d.items()}

        gyro = torch.rand((state.p.shape[0], 3), generator=torch.Generator().manual_seed(3),
                          dtype=torch.float32)
        return dict(source_draws=draws, gyro_draws=lambda step, k: gyro.to(device))

    def step_on(device, state):
        mesh = make_mesh(device=device) if cfg.axis_name else None
        return magnetized.make_step(cfg, mesh=mesh, **hooks(device, state))

    for _ in range(3):
        st, _ = step_on("cpu", st)(st)
    d = interop.magnetized_state_to_numpy(st)
    c, mc = step_on("cpu", st)(st)
    cuda_cic.reset_launch_counts()
    magnetized.THOMAS_SOLVES.update(dirichlet=0, dirichlet_neumann=0)
    g_in = interop.magnetized_state_from_numpy(d, cuda_device)
    g, mg = step_on(cuda_device, g_in)(g_in)
    torch.cuda.synchronize()
    launched = {k for k, n in cuda_cic.LAUNCHES.items() if n}
    newton = "boltzmann_dn_f64" if kind == "dn" else "boltzmann_dirichlet_f64"
    # the carried re-activation patch deposits the float32 draws' rows in
    # float32, as JAX's does
    float32 = {"deposit2"} if cfg.carried_deposit == "on" else set()
    assert newton in launched and all(k.endswith("_f64") or k in float32
                                      for k in launched), launched
    assert sum(magnetized.THOMAS_SOLVES.values()) == 0
    for k in ("p", "vx", "phi", "rho", "n"):
        assert getattr(g, k).dtype == torch.float64, k
    assert torch.equal(c.active, g.active.cpu())
    for k in ("n_reactivated", "n_hit_wall", "carry_clamped", "newton_iters"):
        assert int(getattr(mc, k)) == int(getattr(mg, k)), k
    react = (c.active == 1) & torch.from_numpy(d["active"] != 1)
    act = (c.active == 1) & ~react
    gp = g.p.cpu()
    assert float((c.p - gp)[act].abs().max()) <= TOL64_MAG_STEP["p"]
    for k in ("vx", "vy", "vz"):
        ref, got = getattr(c, k)[act], getattr(g, k).cpu()[act]
        # (the guiding centers' vz is 0 on both sides)
        assert float((ref - got).abs().max()) <= TOL64_MAG_STEP["v"] * float(
            ref.abs().max()), k
    dp = float((c.p - gp)[react].abs().max()) if bool(react.any()) else 0.0
    if bool(react.any()):
        for k in ("p", "vx", "vy", "vz"):
            ref = getattr(c, k)[react]
            gap = float((ref - getattr(g, k).cpu()[react]).abs().max())
            assert gap <= TOL64_REACTIVATED * max(float(ref.abs().max()), 1e-300), k
    assert _rel(mc.phi, mg.phi.cpu()) <= TOL64_MAG_STEP["phi"]
    if cfg.carried_deposit == "on":
        w = torch.where(react, c.p2c / cfg.grid.dx, 0.0)
        moved = {"rho": float((w * c.charge_state * E_CHARGE).abs().sum()),
                 "n": float(w.abs().sum())}
        for k in ("rho", "n"):
            ref = getattr(c, k)
            allowed = TOL64_MAG_STEP["rho"] + dp * moved[k] / float(ref.abs().max())
            assert _rel(ref, getattr(g, k).cpu()) <= allowed, k


# ---------------------------------------------------------------------------
# the explicit engine's double kernels (ROADMAP item 19c): the two-stage
# sweep (row 14, both modes) and the one-kernel cycle (row 13)
# ---------------------------------------------------------------------------

EXPLICIT_KW = dict(qm=QM, w=W, dt=DT, dx=DX)
# row 13's e1 against the float64 direct solve of its own rho (the same
# algorithm, float64 sums in another order), relative to max |e1|; and
# against the plain version's e1, which solves the plain rho (its sums in
# another order again, carried through the prefix sums)
TOL64_SOLVE, TOL64_SOLVE_PLAIN = 1e-12, 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 4096, 40_000])
def test_double_leapfrog_deposit_matches_plain(cuda_device, ng):
    """Row 14 in double at a ragged n = 4097 with the edge positions: p1
    and v1 bit-equal to the float64 plain version (each operation rounded
    once in double on both sides), rho1 within 16 n eps64 of the largest
    node; the shared mode to 14,528 nodes, above it cluster_launch's mode
    (at 4,097 rows and 40,000 nodes the global mode: fewer rows a node
    than CLUSTER_MIN_ROWS_PER_NODE)."""
    e, _, p0, v0 = _inputs(ng, cuda_device)
    cuda_cic.reset_launch_counts()
    got = cuda_cic.leapfrog_gather_push_deposit(e, p0, v0, **EXPLICIT_KW)
    ref = cuda_cic.leapfrog_gather_push_deposit_plain(e.cpu(), p0.cpu(), v0.cpu(),
                                                      **EXPLICIT_KW)
    torch.cuda.synchronize()
    name = "leapfrog_gather_push_deposit"
    assert cuda_cic.LAUNCHES[f"{name}_f64"] == 1 and cuda_cic.LAUNCHES[name] == 0
    mode = cuda_cic.cluster_launch(name, N, ng, 132, item=8).mode
    assert (mode == "shared") == (ng <= 14_528)
    assert dict(cuda_cic.LARGE_LAUNCHES) == ({f"{name}_f64 {mode}": 1} if mode != "shared"
                                             else {})
    assert all(t.dtype == torch.float64 for t in got)
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    assert _rel(ref[2], got[2].cpu()) <= TOL_SUM


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 200, 1024])
def test_double_explicit_cycle_matches_plain(cuda_device, ng):
    """Row 13 in double: p1, v1 bit-equal to the float64 plain version,
    rho1 within 16 n eps64 of the largest node, e1 within TOL64_SOLVE of
    the float64 direct solve of the kernel's own rho1 and TOL64_SOLVE_PLAIN
    of the plain version's e1; the epilogue's ticket (the first word of
    the double after rho) starts from 0 at every launch: two launches give
    the same e1 to TOL64_SOLVE."""
    e, _, p0, v0 = _inputs(ng, cuda_device)
    cuda_cic.reset_launch_counts()
    got = cuda_cic.explicit_cycle(e, p0, v0, ng, **EXPLICIT_KW)
    again = cuda_cic.explicit_cycle(e, p0, v0, ng, **EXPLICIT_KW)
    ref = cuda_cic.explicit_cycle_plain(e.cpu(), p0.cpu(), v0.cpu(), ng, **EXPLICIT_KW)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES["explicit_cycle_f64"] == 2
    assert cuda_cic.LAUNCHES["explicit_cycle"] == 0
    assert all(t.dtype == torch.float64 for t in got) and got[3].shape == (ng,)
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    assert _rel(ref[2], got[2].cpu()) <= TOL_SUM
    own = cuda_cic.field_from_rho_plain(got[2].cpu(), DX)
    assert _rel(own, got[3].cpu()) <= TOL64_SOLVE
    assert _rel(ref[3], got[3].cpu()) <= TOL64_SOLVE_PLAIN
    assert _rel(got[3].cpu(), again[3].cpu()) <= TOL64_SOLVE


EXPLICIT64_ROUTES = {"one-kernel ng 64": (64, "auto", {"explicit_cycle_f64"}),
                     "two-stage ng 2048": (2048, "auto", {"leapfrog_gather_push_deposit_f64"}),
                     "two-stage ng 40000": (40_000, "auto",
                                            {"leapfrog_gather_push_deposit_f64"}),
                     "composed ng 64": (64, "composed", {"gather_f64", "deposit_f64"})}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(EXPLICIT64_ROUTES))
def test_float64_explicit_step_card_matches_cpu(cuda_device, route):
    """The explicit two-stream at n = 20,000 in float64: three steps on
    the CPU, and on the card one step from each CPU state. p and v within
    1e-10 (cells; of the largest v), rho, e and the energies within 1e-10
    of their largest (float64 sums in other orders); only the route's
    double kernels launch; the state stays float64."""
    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import explicit
    from pypic_tpu_torch.tools import two_stream

    ng, backend, kernels = EXPLICIT64_ROUTES[route]
    cfg, _, st = two_stream.state(20_000, "cpu", ng=ng, dtype=torch.float64,
                                  backend=backend)
    step = explicit.make_step(cfg)
    for _ in range(3):
        d = interop.explicit_state_to_numpy(st)
        c, mc = step(st)
        cuda_cic.reset_launch_counts()
        g, mg = step(interop.explicit_state_from_numpy(d, cuda_device))
        torch.cuda.synchronize()
        assert {k for k, n in cuda_cic.LAUNCHES.items() if n} == kernels
        assert {getattr(g, k).dtype for k in ("p", "v", "rho", "e")} == {torch.float64}
        dp = (c.p - g.p.cpu()).abs()
        assert float(torch.minimum(dp, ng - dp).max()) <= 1e-10
        for k in ("v", "rho", "e"):
            assert _rel(getattr(c, k), getattr(g, k).cpu()) <= 1e-10, k
        for k in ("field_energy", "kinetic_energy"):
            assert _rel(getattr(mc, k).reshape(1), getattr(mg, k).cpu().reshape(1)) <= 1e-10
        st = c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,top", [(torch.float32, 14_511), (torch.float64, 9_674)])
def test_explicit_cycle_launches_at_its_ceilings(cuda_device, dtype, top):
    """Row 13 launches at its last node (check_cycle_smem, the ticket's 16
    static bytes counted) and its wrapper raises a ValueError naming the
    shared memory one node above, before any launch (Fault 9: the card
    refused the float kernel at 14,512, which the check passed)."""
    p = torch.rand(4096, device=cuda_device, dtype=dtype) * top
    v = torch.zeros_like(p)
    cuda_cic.reset_launch_counts()
    out = cuda_cic.explicit_cycle(torch.zeros(top, dtype=dtype, device=cuda_device), p, v,
                                  top, **EXPLICIT_KW)
    torch.cuda.synchronize()
    assert out[3].shape == (top,) and bool(torch.isfinite(out[3]).all())
    with pytest.raises(ValueError, match="shared memory"):
        cuda_cic.explicit_cycle(torch.zeros(top + 1, dtype=dtype, device=cuda_device),
                                p, v, top + 1, **EXPLICIT_KW)
    name = "explicit_cycle" + ("_f64" if dtype == torch.float64 else "")
    assert cuda_cic.LAUNCHES[name] == 1
