"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode)
and skips without one.

The magnetized kernels run at n = 999,996 (bench.py's configs[3] row) and
a ragged n, ng = 600 (the carried Boris deposit also with a forced
clamp); the carried domain cycle on the 227-node extended slab of the
carried carrier; the sheath kernels at n = 1,000,000 (configs[2]) and
a ragged n, ng = 51 and 11; the pic_bca_aps step (ppc 20, seeded with
neutral wall-born rows) against its plain versions, and a checkpoint round
trip on the card; their tolerances are stated beside each test.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs and tolerances are those of tests/test_torch_kernels.py and
tests/test_torch_explicit.py: n = 4097 (ragged), edge positions 0,
ng - 1e-4 and ng, positions 1e-4 cells, currents, deposits and gathers
2e-5 and velocities 1e-4 of the largest magnitude. The explicit cycle's
field is also held against a float64 FFT solve of its own rho (1e-6: one
float32 rounding of a float64 solve), and the resident kernel against
launches of the per-step cycle and its plain version on a two-stream load.
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch.engines import explicit
from pypic_tpu_torch.ops import cic, cuda_cic, fd, poisson
from pypic_tpu_torch.tools import two_stream

N = 4097
QM, W, DT, DX = -1.7e11, -3.2e-9, 1e-7, 0.05


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(ng, dev, seed=7):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, ng, N).astype(np.float32)
    v0 = (rng.normal(size=N) * 1e5).astype(np.float32)
    ps = rng.uniform(0, ng, N).astype(np.float32)
    e = (rng.normal(size=ng) * 1e3).astype(np.float32)
    edge = np.array([0.0, ng - 1e-4, ng], np.float32)
    p0[:3] = edge
    ps[:3] = edge
    ps[3:6] = edge
    v0[:3] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (e, ps, p0, v0)]


def _pos_close(a, b, ng, tol=1e-4):
    d = (a.double() - b.double()).abs().cpu().numpy()
    assert np.minimum(d, ng - d).max() < tol


def _rel_close(ref, got, rel):
    ref = ref.double().cpu().numpy()
    np.testing.assert_allclose(got.double().cpu().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("emit_v", [False, True])
@pytest.mark.parametrize("ng", [64, 129, 200])
def test_picard_iteration_kernel_matches_plain(cuda_device, ng, emit_v):
    e, ps, p0, v0 = _inputs(ng, cuda_device)
    kw = dict(qm=QM, w=W, dt=DT, dx=DX, emit_v=emit_v)
    before = cuda_cic.LAUNCHES["picard_iteration"]
    got = cuda_cic.picard_iteration(e, ps, p0, v0, ng, **kw)
    ref = cuda_cic.picard_iteration_plain(e, ps, p0, v0, ng, **kw)
    assert cuda_cic.LAUNCHES["picard_iteration"] == before + 1
    assert all(t.is_cuda and t.dtype == torch.float32 for t in got)
    _pos_close(ref[0], got[0], ng)
    _rel_close(ref[-1], got[-1], 2e-5)
    if emit_v:
        _rel_close(ref[1], got[1], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 129, 200])
def test_picard_finalize_nodep_kernel_matches_plain(cuda_device, ng):
    e, ps, p0, v0 = _inputs(ng, cuda_device, seed=11)
    p1, v1 = cuda_cic.picard_finalize_nodep(e, ps, p0, v0, ng, qm=QM, dt=DT, dx=DX)
    p1r, v1r = cuda_cic.picard_finalize_nodep_plain(e, ps, p0, v0, ng, qm=QM,
                                                    dt=DT, dx=DX)
    _pos_close(p1r, p1, ng)
    _rel_close(v1r, v1, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "bounded"])
@pytest.mark.parametrize("ng", [64, 129, 200])
def test_deposit_kernel_matches_plain(cuda_device, ng, periodic):
    _, _, p0, v0 = _inputs(ng, cuda_device, seed=3)
    pos = p0 if periodic else p0 * ((ng - 1) / ng)
    got = cuda_cic.deposit(pos, v0, ng, periodic=periodic)
    ref = cuda_cic.deposit_plain(pos, v0, ng, periodic=periodic)
    _rel_close(ref, got, 2e-5)


# row 4 on its wide grid (n >= 4 x 1,024 x SMs rows): the explicit
# carrier's slab (ext_n = 227, bounded, a twentieth dead slots of weight
# 0), the headline's set-up (ng = 200, periodic, a ragged n read through a
# view one float in: 4-B loads) and the IEAD histogram (3,200 bins,
# integer positions, weight 1 on 1% of the rows: counts, exact)
WIDE_DEPOSIT_CASES = {"carrier": (999_996, 227), "headline": (1_000_003, 200),
                      "IEAD": (999_996, 3200)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WIDE_DEPOSIT_CASES))
def test_deposit_wide_grid_matches_plain(cuda_device, case):
    """The deposit on its wide grid within 2e-5 of a float64 deposit of
    the same values (the IEAD's counts equal to the plain version's,
    exactly, at the default columns and at histogram_add's one column, the
    IEAD path's), one launch counted each; a product of 0 adds nothing, a
    NaN still lands."""
    n, ng = WIDE_DEPOSIT_CASES[case]
    rng = np.random.default_rng(17)
    periodic = case == "headline"
    if case == "IEAD":
        p = rng.integers(0, ng, n).astype(np.float32)
        v = (rng.uniform(size=n) < 0.01).astype(np.float32)
    else:
        p = rng.uniform(13.0, 213.0, n).astype(np.float32) if case == "carrier" else \
            rng.uniform(0, ng, n).astype(np.float32)
        v = rng.normal(0.0, 1e3, n).astype(np.float32)
        if case == "carrier":
            dead = rng.uniform(size=n) < 0.05
            v[dead] = 0.0
            p[dead] = 13.0
    pt, vt = (torch.from_numpy(a).to(cuda_device) for a in (p, v))
    if case == "headline":  # a view one float in: not 16-B aligned
        pt = torch.cat([pt.new_zeros(1), pt])[1:]
        vt = torch.cat([vt.new_zeros(1), vt])[1:]
    assert cuda_cic._deposit_shape(cuda_device, n, ng, False, hists=1).rows == 4
    before = cuda_cic.LAUNCHES["deposit"]
    got = cuda_cic.deposit(pt, vt, ng, periodic=periodic)
    assert cuda_cic.LAUNCHES["deposit"] == before + 1
    if case == "IEAD":
        counts = cuda_cic.deposit_plain(pt.cpu(), vt.cpu(), ng, periodic=False)
        assert torch.equal(got.cpu(), counts)
        assert cuda_cic._deposit_shape(cuda_device, n, ng, False, hists=1,
                                       max_cols=cic.HISTOGRAM_COLS).cols == 1
        hist = cic.histogram_add(pt.long(), vt, ng)
        assert cuda_cic.LAUNCHES["deposit"] == before + 2
        assert torch.equal(hist.cpu(), counts)
    _rel_close(cuda_cic.deposit_plain(pt.double(), vt.double(), ng, periodic=periodic),
               got, 2e-5)
    vt = vt.clone()
    vt[5] = float("nan")
    assert torch.isnan(cuda_cic.deposit(pt, vt, ng, periodic=periodic)).any()


@pytest.mark.cuda
def test_large_shared_memory_grid(cuda_device):
    """ng above the 48 KB default shared-memory window needs the opt-in
    attribute; the kernel must still launch and agree."""
    ng = 20_000  # 160 KB for the Picard pass's field + histogram
    e, ps, p0, v0 = _inputs(ng, cuda_device, seed=5)
    got = cuda_cic.picard_iteration(e, ps, p0, v0, ng, qm=QM, w=W, dt=DT, dx=DX)
    ref = cuda_cic.picard_iteration_plain(e, ps, p0, v0, ng, qm=QM, w=W, dt=DT, dx=DX)
    _pos_close(ref[0], got[0], ng)
    _rel_close(ref[-1], got[-1], 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "bounded"])
@pytest.mark.parametrize("ng", [64, 129, 200])
def test_gather_kernel_matches_plain(cuda_device, ng, periodic):
    e, ps, _, _ = _inputs(ng, cuda_device, seed=13)
    pos = ps if periodic else ps * ((ng - 1) / ng)
    before = cuda_cic.LAUNCHES["gather"]
    got = cuda_cic.gather(e, pos, periodic=periodic)
    assert cuda_cic.LAUNCHES["gather"] == before + 1
    _rel_close(cuda_cic.gather_plain(e, pos, periodic=periodic), got, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 200, 4096])
def test_leapfrog_deposit_kernel_matches_plain(cuda_device, ng):
    e, _, p0, v0 = _inputs(ng, cuda_device, seed=17)
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    got = cuda_cic.leapfrog_gather_push_deposit(e, p0, v0, **kw)
    ref = cuda_cic.leapfrog_gather_push_deposit_plain(e, p0, v0, **kw)
    _pos_close(ref[0], got[0], ng)
    assert bool(((got[0] >= 0) & (got[0] <= ng)).all())
    _rel_close(ref[1], got[1], 1e-4)
    _rel_close(ref[2], got[2], 2e-5)


def _field64(rho, dx):
    r = rho.double().cpu()
    return -fd.grad_periodic(poisson.solve_periodic_neutralized(r, dx), dx)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, N])
@pytest.mark.parametrize("ng", [64, 200, 1024])
def test_explicit_cycle_kernel_matches_plain(cuda_device, ng, n):
    e, _, p0, v0 = _inputs(ng, cuda_device, seed=19)
    p0, v0 = p0[:n].contiguous(), v0[:n].contiguous()
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    for _ in range(2):  # a second launch starts from a fresh block counter
        got = cuda_cic.explicit_cycle(e, p0, v0, ng, **kw)
    ref = cuda_cic.explicit_cycle_plain(e, p0, v0, ng, **kw)
    _pos_close(ref[0], got[0], ng)
    _rel_close(ref[1], got[1], 1e-4)
    _rel_close(ref[2], got[2], 2e-5)
    _rel_close(ref[3], got[3], 2e-5)
    _rel_close(_field64(got[2], DX), got[3], 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 10_000, 32768])
def test_explicit_resident_kernel_matches_cycle_and_plain(cuda_device, n):
    """37 steps in chunks of 16, 16 and 5 against 37 launches of the
    one-kernel cycle and against the plain resident version. Over 37 steps
    the deposits' summation order moves positions by a few float32 ulps
    (a 1e-7 change of the field moves them by 9e-5 cells on the CPU; the
    H100 reads 1.1e-4 cells against the plain version at n = 32768), so
    positions are held at the engine tests' 2e-3 cells, not the 1e-4 of
    one launch. chip_smoke.py holds the kernel at the same limits."""
    ng, steps = 200, 37
    cfg, _, st0 = two_stream.state(n, cuda_device, ng=ng)
    kw = explicit.resident_kwargs(st0, cfg)
    consts = {k: kw[k] for k in ("qm", "w", "dt", "dx")}
    e, p, v = st0.e, st0.p, st0.v
    st = (p, v, None, e)
    out = {"fe": [], "ke": [], "jb": []}
    before = cuda_cic.LAUNCHES["explicit_cycle_resident"]
    for chunk in (16, 16, 5):
        *st, fe, ke, jb = cuda_cic.explicit_cycle_resident(
            st[3], st[0], st[1], ng, chunk, **kw)
        for k, r in zip(("fe", "ke", "jb"), (fe, ke, jb)):
            out[k].append(r)
    assert cuda_cic.LAUNCHES["explicit_cycle_resident"] == before + 3
    cyc = (p, v, None, e)
    for _ in range(steps):
        cyc = cuda_cic.explicit_cycle(cyc[3], cyc[0], cyc[1], ng, **consts)
    plain = cuda_cic.explicit_cycle_resident_plain(e, p, v, ng, steps, **kw)
    for ref in (cyc, plain[:4]):
        _pos_close(ref[0], st[0], ng, 2e-3)
        _rel_close(ref[1], st[1], 1e-4)
        _rel_close(ref[2], st[2], 2e-5)
        _rel_close(ref[3], st[3], 1e-4)
    for k, ref in zip(("fe", "ke", "jb"), plain[4:]):
        got = torch.cat(out[k])
        assert got.shape == (steps,)
        _rel_close(ref, got, 1e-5 if k != "fe" else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [2, 1024])
def test_explicit_resident_kernel_at_the_column_layouts_ends(cuda_device, ng):
    """The smallest and the largest grid of the resident kernel
    (explicit_resident_shape: 32 deposit columns a node at both; at
    ng = 1024 the columns, the receive buffers and the field fill 207 KB,
    and each thread owns two nodes) at the kernel's largest n, 32,768 (8
    particles a thread): 37 steps in chunks of 16, 16 and 5 against 37
    launches of the one-kernel cycle and against the plain resident
    version. Positions, velocities and the metric rows at the limits of
    test_explicit_resident_kernel_matches_cycle_and_plain. rho and e are
    held to what they must be, the deposit of the kernel's own final
    positions (2e-5 of the largest node against float64, TOL_DEP) and the
    solve of its own rho (1e-6 of the largest node against the float64
    solve, one float32 rounding), not to the other trajectories' rho: at
    32 particles a cell one particle moved by the float32 summation order
    (~1e-4 cells in 37 steps, within the 2e-3 of the positions) moves a
    node by more than 2e-5 (H100: 2.4e-5 against the one-kernel cycle).
    On two nodes the periodic field is 0 in exact arithmetic (d_1 = -d_0),
    so the solved e and fe are float64 rounding noise on every side: they
    are held below 1e-9 of the field one node's charge would make,
    dx / (2 eps0) max|rho|, instead."""
    n, steps = 32_768, 37
    cfg, _, st0 = two_stream.state(n, cuda_device, ng=ng)
    kw = explicit.resident_kwargs(st0, cfg)
    consts = {k: kw[k] for k in ("qm", "w", "dt", "dx")}
    e, p, v = st0.e, st0.p, st0.v
    st = (p, v, None, e)
    out = {"fe": [], "ke": [], "jb": []}
    for chunk in (16, 16, 5):
        *st, fe, ke, jb = cuda_cic.explicit_cycle_resident(
            st[3], st[0], st[1], ng, chunk, **kw)
        for k, r in zip(("fe", "ke", "jb"), (fe, ke, jb)):
            out[k].append(r)
    cyc = (p, v, None, e)
    for _ in range(steps):
        cyc = cuda_cic.explicit_cycle(cyc[3], cyc[0], cyc[1], ng, **consts)
    plain = cuda_cic.explicit_cycle_resident_plain(e, p, v, ng, steps, **kw)
    for ref in (cyc, plain[:4]):
        _pos_close(ref[0], st[0], ng, 2e-3)
        _rel_close(ref[1], st[1], 1e-4)
    w32 = cuda_cic.leapfrog_scalars(kw["qm"], kw["dt"], kw["dx"], kw["w"])[2]
    rho64 = cuda_cic.deposit_plain(st[0].double(),
                                   torch.full((n,), w32, dtype=torch.float64,
                                              device=cuda_device), ng, periodic=True)
    _rel_close(rho64, st[2], 2e-5)
    field = cuda_cic._solve_coef(kw["dx"]) * float(st[2].abs().max())
    if ng > 2:
        _rel_close(cuda_cic.field_from_rho_plain(st[2], kw["dx"]), st[3], 1e-6)
    else:
        for got in (st[3], cyc[3], plain[3]):
            assert float(got.abs().max()) < 1e-9 * field
    for k, ref in zip(("fe", "ke", "jb"), plain[4:]):
        got = torch.cat(out[k])
        assert got.shape == (steps,)
        if k == "fe" and ng == 2:
            # row 0 is the input field's (the FFT solve of init_state);
            # the later rows are the fields the kernels solved
            _rel_close(ref[:1], got[:1], 1e-4)
            bound = kw["fe_c"] * ng * (1e-9 * field) ** 2
            assert float(got[1:].max()) < bound and float(ref[1:].max()) < bound
        else:
            _rel_close(ref, got, 1e-5 if k != "fe" else 1e-4)


@pytest.mark.cuda
def test_explicit_resident_smem_is_the_kernels(cuda_device):
    """explicit_resident_shape's shared memory is what the resident
    kernel's launcher allocates (csrc/explicit.cu resident_smem), at every
    ng the kernel takes."""
    from pypic_tpu_torch.ops import _build

    lib = _build.library()
    for ng in range(2, cuda_cic.RESIDENT_MAX_NG + 1):
        assert (lib.pypic_explicit_resident_smem(ng)
                == cuda_cic.explicit_resident_shape(1, ng).smem), ng


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 129, 200])
def test_picard_finalize_kernel_matches_plain(cuda_device, ng):
    """The converged-deposit sweep: p1 and v1 bit-identical to
    picard_finalize_nodep's kernel, j1 within 2e-5 of the plain deposit."""
    e, ps, p0, v0 = _inputs(ng, cuda_device, seed=23)
    kw = dict(qm=QM, dt=DT, dx=DX)
    before = cuda_cic.LAUNCHES["picard_finalize"]
    p1, v1, j1 = cuda_cic.picard_finalize(e, ps, p0, v0, ng, w=W, **kw)
    assert cuda_cic.LAUNCHES["picard_finalize"] == before + 1
    p1n, v1n = cuda_cic.picard_finalize_nodep(e, ps, p0, v0, ng, **kw)
    assert torch.equal(p1, p1n) and torch.equal(v1, v1n)
    ref = cuda_cic.picard_finalize_plain(e, ps, p0, v0, ng, w=W, **kw)
    _pos_close(ref[0], p1, ng)
    _rel_close(ref[1], v1, 1e-4)
    _rel_close(ref[2], j1, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unclamped", "clamped"])
@pytest.mark.parametrize("ng", [64, 200])
def test_picard_iteration_shared_kernel_matches_plain(cuda_device, ng, case):
    """The shared-window pass: the clamp count equals the plain version's
    exactly. The unclamped case seeds the guess at the free-streaming
    midpoint under a weak field; the clamped one draws it anywhere under a
    strong field."""
    e, ps, p0, v0 = _inputs(ng, cuda_device, seed=29)
    clamped = case == "clamped"
    if not clamped:
        e = e * 1e-3
        ps = p0 + (0.5 * DT / DX) * v0
        ps = ps - torch.floor(ps * (1.0 / ng)) * ng
    kw = dict(qm=QM, w=W, dt=DT, dx=DX, emit_v=clamped)
    before = cuda_cic.LAUNCHES["picard_iteration_shared"]
    got = cuda_cic.picard_iteration_shared(e, ps, p0, v0, ng, **kw)
    assert cuda_cic.LAUNCHES["picard_iteration_shared"] == before + 1
    ref = cuda_cic.picard_iteration_shared_plain(e, ps, p0, v0, ng, **kw)
    assert got[-1].is_cuda and got[-1].dtype == torch.int32
    assert int(got[-1]) == int(ref[-1])
    assert (int(got[-1]) > N // 2) if clamped else (int(got[-1]) == 0)
    _pos_close(ref[0], got[0], ng)
    _rel_close(ref[-2], got[-2], 2e-5)
    if clamped:
        _rel_close(ref[1], got[1], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 100_000, 131_071, 131_072])
@pytest.mark.parametrize("conf", ["field-none", "extrapolate-anderson"])
def test_implicit_resident_kernel_matches_step_and_plain(cuda_device, conf, n):
    """25 resident steps in chunks of 8 (three launches and a remainder)
    against 25 per-step steps of the fused engine and against the plain
    resident version, on bench.py's Landau cell: the criteria of
    tests/test_pallas.py:459-470 (iterations equal, fe rtol 1e-4, ke 1e-5,
    positions 5e-3 cells) and the final v, e, e_prev and j within 1e-4 of
    the largest magnitude. Counts may differ only at a step whose residual
    sat at tol, one pass apart and within the runs' measured residual gap
    (diagnostics.picard_counts_agree): another summation order of the
    float atomics moves a residual by that gap, and the H100 read 3
    passes against 4 at one step of 25 at n = 4097, tol 1e-9. The
    fixed-count configuration (tol 1e-30) can differ nowhere."""
    import dataclasses

    from pypic_tpu_torch.diagnostics import picard_counts_agree
    from pypic_tpu_torch.engines import implicit
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import landau

    opts = {"field-none": dict(tol=1e-9, maxiter=50),
            "extrapolate-anderson": dict(tol=1e-30, maxiter=4,
                                         picard_init="extrapolate",
                                         picard_accel="anderson")}[conf]
    cfg, st = landau.state(n, cuda_device)
    cfg = dataclasses.replace(cfg, **opts)
    before = cuda_cic.LAUNCHES["implicit_resident"]
    fin, m = implicit.run_resident(cfg, st, 25, steps_per_call=8)
    assert cuda_cic.LAUNCHES["implicit_resident"] == before + 4
    ref, rm = run(implicit.make_step(cfg), st, 25)
    plain = cuda_cic.implicit_resident_plain(
        st.e, st.e_prev, st.j, st.p, st.v, cfg.grid.ng, 25,
        **implicit.resident_kwargs(st, cfg))
    ng = cfg.grid.ng
    for iters, resid, fe, ke, final in (
            (rm.picard_iters, rm.picard_residual, rm.field_energy,
             rm.kinetic_energy, (ref.p, ref.v, ref.e, ref.e_prev, ref.j)),
            (plain[5]["iters"], plain[5]["resid"], plain[5]["fe"],
             plain[5]["ke"], plain[:5])):
        ok, lines = picard_counts_agree(m.picard_iters, m.picard_residual,
                                        iters, resid, float(np.float32(cfg.tol)))
        print("\n".join(lines))
        assert ok, lines
        np.testing.assert_allclose(m.field_energy.double().cpu().numpy(),
                                   fe.double().cpu().numpy(), rtol=1e-4)
        np.testing.assert_allclose(m.kinetic_energy.double().cpu().numpy(),
                                   ke.double().cpu().numpy(), rtol=1e-5)
        _pos_close(final[0], fin.p, ng, 5e-3)
        for r_, g_ in zip(final[1:], (fin.v, fin.e, fin.e_prev, fin.j)):
            _rel_close(r_, g_, 1e-4)
    assert int(fin.step) == 25


# ---------------------------------------------------------------------------
# the magnetized engine's kernels: n = 999,996 (bench.py's configs[3] row)
# and a ragged n, ng = 600
# ---------------------------------------------------------------------------

N_MAG = (999_996, 4097)
NG_MAG = 600
# the deposits also at the shapes of their other paths: the carried row's
# re-activation patch (react_batch rows) and the D-N row, at ng = 800
DEPOSIT_CASES = [(n, NG_MAG) for n in N_MAG] + [(16_384, 800), (50_000, 800)]


def _mag_inputs(n, dev, seed=3, ng=NG_MAG):
    """Bounded-grid particles with a tenth inactive, some off the grid
    (wall-lost slots) with weight 0."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, ng - 1, n).astype(np.float32)
    p[:4] = [0.0, ng - 1, -0.3, ng - 0.7]
    v = rng.normal(0, 2e4, (3, n)).astype(np.float32)
    act = (rng.uniform(size=n) < 0.9).astype(np.float32)
    act[2:4] = 0.0
    const = (rng.integers(1, 6, n) * (0.5 * 1e-10 * 1.602e-19 / 1.8e-26)).astype(np.float32)
    field = rng.normal(0, 1e5, ng).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (field, p, *v, const, act)]


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True], ids=["bounded", "periodic"])
@pytest.mark.parametrize("n, ng", DEPOSIT_CASES)
def test_deposit2_kernel_matches_plain(cuda_device, n, ng, periodic):
    """Both deposits against the plain version (float32, summed in another
    order: 5e-5 of the largest node) and against a float64 deposit of the
    same values (2e-5)."""
    _, p, vx, vy, _, _, act = _mag_inputs(n, cuda_device, ng=ng)
    va, vb = vx * act, vy.abs() * act
    before = cuda_cic.LAUNCHES["deposit2"]
    a, b = cuda_cic.deposit2(p, va, vb, ng, periodic=periodic)
    assert cuda_cic.LAUNCHES["deposit2"] == before + 1
    ra, rb = cuda_cic.deposit2_plain(p, va, vb, ng, periodic=periodic)
    da, db = cuda_cic.deposit2_plain(p.double(), va.double(), vb.double(),
                                     ng, periodic=periodic)
    for got, ref, ref64 in ((a, ra, da), (b, rb, db)):
        _rel_close(ref, got, 5e-5)
        _rel_close(ref64, got, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 5, 255, 257, 540_671, 540_672, 540_673])
def test_deposits_at_the_launch_edges(cuda_device, n):
    """The launch's edge shapes (one block of one row and more, around 256
    rows, and on both sides of the change from the narrow grid to the wide
    one at 4 x 1,024 x 132 rows): both deposits within 2e-5 of a float64
    deposit, the clamp count equal."""
    field, p, vx, vy, vz, const, act = _mag_inputs(n, cuda_device)
    va, vb = vx * act, vy.abs() * act
    got = cuda_cic.deposit2(p, va, vb, NG_MAG, periodic=False)
    ref = cuda_cic.deposit2_plain(p.double(), va.double(), vb.double(), NG_MAG,
                                  periodic=False)
    for g, r in zip(got, ref):
        _rel_close(r, g, 2e-5)
    act = act * ((p >= 0) & (p <= NG_MAG - 1)).float()
    args = (field, p, vx, vy, vz, const, act, act * 3.2, act * 1.5)
    kw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6, pad=2,
              swap_weights=True)
    got = cuda_cic.boris_gather_push_deposit(*args, **kw)
    ref = cuda_cic.boris_gather_push_deposit_plain(*args, acc_dtype=torch.float64,
                                                   **kw)
    for i in (4, 5):
        _rel_close(ref[i], got[i], 2e-5)
    assert int(got[6]) == int(ref[6])


@pytest.mark.cuda
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("n", N_MAG)
def test_boris_gather_push_kernel_matches_plain(cuda_device, n, swap):
    """The same float32 operations in the same order: positions within
    1e-4 cells, velocities 1e-6 of the largest; inactive rows hold their
    inputs bit for bit."""
    field, p, vx, vy, vz, const, act = _mag_inputs(n, cuda_device)
    kw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6, swap_weights=swap)
    before = cuda_cic.LAUNCHES["boris_gather_push"]
    got = cuda_cic.boris_gather_push(field, p, vx, vy, vz, const, act, **kw)
    assert cuda_cic.LAUNCHES["boris_gather_push"] == before + 1
    ref = cuda_cic.boris_gather_push_plain(field, p, vx, vy, vz, const, act, **kw)
    live = act > 0
    assert float((got[0] - ref[0]).abs().max()) < 1e-4
    for r, g in zip(ref[1:], got[1:]):
        _rel_close(r, g, 1e-6)
    for g, held in zip(got, (p, vx, vy, vz)):
        assert torch.equal(g[~live], held[~live])


@pytest.mark.cuda
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("n, ng, pad, hot", [
    (999_996, NG_MAG, 2, 1.0), (1_000_003, NG_MAG, 0, 40.0),
    (16_384, 800, 2, 1.0), (50_000, 800, 2, 1.0)],
    ids=["row", "forced clamp", "16384 at ng 800", "50000 at ng 800"])
def test_boris_gather_push_deposit_kernel_matches_plain(cuda_device, n, ng,
                                                        pad, hot, swap):
    """The carried sweep at the configs[3] row's n and pad, ragged with a
    forced clamp (pad 0, 40x the velocities), and at the other deposit
    paths' shapes: p1 and the velocities bit-equal to the plain version's
    (the same float32 operations), rho and n within 2e-5 of a float64 sum
    of the plain version's terms, the clamp count equal."""
    field, p, vx, vy, vz, const, act = _mag_inputs(n, cuda_device, ng=ng)
    vx, vy, vz = vx * hot, vy * hot, vz * hot
    act = act * ((p >= 0) & (p <= ng - 1)).float()
    wr, wn = act * 3.2, act * 1.5
    args = (field, p, vx, vy, vz, const, act, wr, wn)
    kw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6, pad=pad,
              swap_weights=swap)
    before = cuda_cic.LAUNCHES["boris_gather_push_deposit"]
    got = cuda_cic.boris_gather_push_deposit(*args, **kw)
    assert cuda_cic.LAUNCHES["boris_gather_push_deposit"] == before + 1
    ref = cuda_cic.boris_gather_push_deposit_plain(*args, **kw)
    exact = cuda_cic.boris_gather_push_deposit_plain(
        *args, acc_dtype=torch.float64, **kw)
    for r, g in zip(ref[:4], got[:4]):
        assert torch.equal(r, g)
    for i in (4, 5):
        _rel_close(exact[i], got[i], 2e-5)
    assert int(got[6]) == int(ref[6])
    if pad == 0:
        assert int(got[6]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [600, 301, 128, 3, 31, 33, 1024])
def test_boltzmann_dirichlet_kernel_matches_plain(cuda_device, ng):
    """The Newton kernel against its plain version (tests/test_pallas.py:
    315-342's cases and criteria): residual <= tol, counts within one
    (tol 1e-9 sits at the float32 floor), phi within 3e-5 of max|phi|;
    warm from the plain answer, equal counts. n0 comes as a device
    tensor. The edge shapes: the fewest rows, one warp, one row past a
    warp, the most rows (one CTA of kernel_rows(ng) threads)."""
    from pypic_tpu_torch.ops import cuda_newton

    rng = np.random.default_rng(11 + ng)
    dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
    rho = torch.from_numpy((1.602e-19 * dens).astype(np.float32)).to(cuda_device)
    n0 = torch.tensor(1e17, dtype=torch.float32, device=cuda_device)
    te, dx = 116000.0, 2e-5
    before = cuda_cic.LAUNCHES["boltzmann_dirichlet"]
    got = cuda_newton.boltzmann_dirichlet(rho, n0, te, dx, tol=1e-9)
    assert cuda_cic.LAUNCHES["boltzmann_dirichlet"] == before + 1
    ref = cuda_newton.boltzmann_dirichlet_plain(rho, n0, te, dx, tol=1e-9)
    assert float(got.residual) <= 1e-9
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    _rel_close(ref.phi, got.phi, 3e-5)
    got_w = cuda_newton.boltzmann_dirichlet(rho, n0, te, dx, tol=1e-9,
                                            phi0=ref.phi)
    ref_w = cuda_newton.boltzmann_dirichlet_plain(rho, n0, te, dx, tol=1e-9,
                                                  phi0=ref.phi)
    assert int(got_w.iterations) == int(ref_w.iterations)
    _rel_close(ref_w.phi, got_w.phi, 3e-5)


# the Newton large path's forced modes against their plain versions: 8
# iterations at tol 0 (the same loop on both sides), phi within 1e-5 of
# its largest (chip_smoke.py TOL_CHAIN: the plain version repeats the
# kernel's operation order; expf against PyTorch's exp and the sums'
# float64 order apart). 1,537 rows at C = 4 CTAs of 128 threads, k = 4:
# the D-N Neumann row ng - 1 on a CTA's first row, row ng - 3 on the CTA
# before's last thread
NEWTON_CLUSTER_FORCED = {1537: (4, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["single", "cluster"])
@pytest.mark.parametrize("kind", ["dd", "dn"])
@pytest.mark.parametrize("ng", [1025, 1537, 4100, 16_384])
def test_newton_large_modes_match_plain(cuda_device, ng, kind, mode, monkeypatch):
    """Rows 22 and 23's large path in each mode ('single': one CTA;
    'cluster': the thread-block cluster, NEWTON_CLUSTER_FORCED's shape
    where named) against its own mode's plain version: one launch of the
    large path in that mode, the same iterations, phi within 1e-5 of its
    largest."""
    from pypic_tpu_torch.ops import cuda_newton

    real = cuda_newton.large_shape
    if mode == "cluster" and ng in NEWTON_CLUSTER_FORCED:
        c, t = NEWTON_CLUSTER_FORCED[ng]
        monkeypatch.setattr(cuda_newton, "large_shape",
                            lambda rows, item=4, m=None, cl=None, th=None, dn=True:
                            real(rows, item, "cluster", c, t, dn))
    rng = np.random.default_rng(11 + ng)
    dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
    te, dx, kw = 116000.0, 2e-5, dict(tol=0.0, maxiter=8, mode=mode)
    cuda_cic.reset_launch_counts()
    if kind == "dd":
        rho = torch.from_numpy((1.602e-19 * dens).astype(np.float32)).to(cuda_device)
        got = cuda_newton.boltzmann_dirichlet(rho, 1e17, te, dx, **kw)
        ref = cuda_newton.boltzmann_dirichlet_plain(rho, 1e17, te, dx, **kw)
        name = "boltzmann_dirichlet_large"
    else:
        n = torch.from_numpy(dens.astype(np.float32)).to(cuda_device)
        zero = torch.zeros(ng, dtype=torch.float32, device=cuda_device)
        got = cuda_newton.boltzmann_dn(n, 0.9e17, te, dx, zero, **kw)
        ref = cuda_newton.boltzmann_dn_plain(n, 0.9e17, te, dx, zero, **kw)
        name = "boltzmann_dn_large"
    torch.cuda.synchronize()
    assert dict(cuda_cic.LARGE_LAUNCHES) == {f"{name} {mode}": 1}
    assert int(got.iterations) == int(ref.iterations) == 8
    _rel_close(ref.phi, got.phi, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", N_MAG + (1_000_003,))
def test_source_batch_kernel_matches_plain(cuda_device, n):
    """The Philox uniforms bit-equal to philox4x32_plain's; the batch
    within 1e-6 (x: of the wrap length, velocities: of the largest) of the
    plain version, libdevice's logf/sinf/cosf against the CPU's."""
    from pypic_tpu_torch.ops import cuda_rng

    key, step = (0, 1), 7
    u = cuda_rng.source_uniforms(key, step, n, device=cuda_device)
    ref_u = cuda_rng.source_uniforms(key, step, n, device="cpu")
    assert torch.equal(u.cpu(), ref_u)
    kw = dict(x_mu=1.5e-3, x_sigma=2.5e-4, x_wrap=3e-3, vth=2.2e4, vx=0.0)
    before = cuda_cic.LAUNCHES["source_batch"]
    got = cuda_rng.source_batch(key, step, n, device=cuda_device, **kw)
    assert cuda_cic.LAUNCHES["source_batch"] == before + 1
    ref = cuda_rng.source_batch(key, step, n, device="cpu", **kw)
    # every output a contiguous row starting 16-B aligned (padded rows)
    assert all(g.is_contiguous() and g.data_ptr() % 16 == 0 for g in got)
    d = (got[0].cpu().double() - ref[0].double()).abs()
    assert float(torch.minimum(d, 3e-3 - d).max()) <= 1e-6 * 3e-3
    for r, g in zip(ref[1:], got[1:]):
        _rel_close(r, g.cpu(), 1e-6)


@pytest.mark.cuda
def test_magnetized_step_card_matches_cpu(cuda_device):
    """One fused step of pic_iead (n = 12,000) on the card and on the CPU
    from the same state after 3 steps, the same Philox draws on both
    sides: tests/test_magnetized.py:461-489's limits (rho rtol 1e-4, phi
    rtol 1e-3, positions rtol 2e-5, velocities rtol 2e-4, equal active
    counts)."""
    import dataclasses

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.runner import run

    pre = presets.pic_iead(n_per_species=2000, device="cpu")
    cfg = dataclasses.replace(pre.config, backend="fused", newton_backend="pallas")
    st, _ = run(magnetized.make_step(cfg), pre.state, 3)
    d = interop.magnetized_state_to_numpy(st)
    out = []
    for dev in ("cpu", cuda_device):
        s = interop.magnetized_state_from_numpy(d, dev)
        out.append(magnetized.make_step(cfg)(s))
    (sc, mc), (sg, mg) = out
    np.testing.assert_allclose(mg.rho.cpu().numpy(), mc.rho.numpy(), rtol=1e-4)
    np.testing.assert_allclose(mg.phi.cpu().numpy(), mc.phi.numpy(), rtol=1e-3,
                               atol=1e-8)
    act = sc.active.numpy() == 1
    np.testing.assert_allclose(sg.p.cpu().numpy()[act], sc.p.numpy()[act],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(sg.v.cpu().numpy()[act], sc.v.numpy()[act],
                               rtol=2e-4, atol=1.0)
    assert int(sg.active.sum()) == int(sc.active.sum())
    assert int(mg.n_reactivated) == int(mc.n_reactivated)


# ---------------------------------------------------------------------------
# the sheath engine's kernels: n = 1,000,000 (bench.py's configs[2] row)
# and a ragged n, ng = 51 and 11
# ---------------------------------------------------------------------------

N_SHEATH = (1_000_000, 4097)
SHEATH_DT, SHEATH_DX = 1e-12, 1e-5


def _sheath_inputs(n, ng, dev, seed=5):
    """Rows inside the grid, exactly at 0 and at cells, pre-lost left and
    right, and rows that cross a wall in the pass; electron and proton
    q/m and weights (tests/test_torch_sheath.py's inputs)."""
    rng = np.random.default_rng(seed)
    cells = float(ng - 1)
    p0 = rng.uniform(0.0, cells, n).astype(np.float32)
    ps = np.clip(p0 + rng.normal(0, 0.2, n), -0.5, cells + 0.5).astype(np.float32)
    ion = rng.uniform(size=n) < 0.5
    qm = np.where(ion, 1.602e-19 / 1.67e-27, -1.602e-19 / 9.11e-31).astype(np.float32)
    u0 = np.where(ion, rng.normal(0, 3e4, n), rng.normal(0, 1.3e6, n)).astype(np.float32)
    w = (np.where(ion, 1.602e-19, -1.602e-19) * 1e9).astype(np.float32)
    act = np.ones(n, np.float32)
    p0[:4] = [0.0, cells, 0.0, cells]
    ps[:4] = p0[:4]
    act[4:40:2] = 0.0
    act[5:40:2] = -1.0
    p0[40:60] = 0.3
    u0[40:60] = -2.5 * SHEATH_DX / SHEATH_DT
    p0[60:80] = cells - 0.3
    u0[60:80] = 2.5 * SHEATH_DX / SHEATH_DT
    es = (rng.normal(size=ng) * 2e4).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (es, ps, p0, u0, qm, w, act)]


@pytest.mark.cuda
@pytest.mark.parametrize("final", [False, True], ids=["picard", "finalize"])
@pytest.mark.parametrize("ng", [51, 11])
@pytest.mark.parametrize("n", N_SHEATH)
def test_sheath_pass_kernels_match_plain(cuda_device, n, ng, final):
    """The sheath Picard pass and finalize against their plain versions on
    the card: positions, velocities and statuses bit-equal (the same
    float32 operations, no FMA); the current bit-equal from call to call
    (summed in a fixed order), against the plain version
    (another summation order: 5e-5 of the largest node) and against a
    float64 deposit of the same terms (2e-5)."""
    from pypic_tpu_torch.ops import cuda_sheath

    args = _sheath_inputs(n, ng, cuda_device)
    kw = dict(dt=SHEATH_DT, dx=SHEATH_DX)
    name = "sheath_finalize" if final else "sheath_picard"
    before = cuda_cic.LAUNCHES[name]
    fn = cuda_sheath.sheath_finalize if final else cuda_sheath.sheath_picard
    plain = (cuda_sheath.sheath_finalize_plain if final
             else cuda_sheath.sheath_picard_plain)
    got = fn(*args, **kw)
    assert cuda_cic.LAUNCHES[name] == before + 1
    assert torch.equal(fn(*args, **kw)[-1], got[-1])  # the same bits again
    ref = plain(*args, **kw)
    for g, r in zip(got[:-1], ref[:-1]):
        assert torch.equal(g, r)
    act1 = got[-2]
    assert bool((act1[40:80] != 1.0).all())
    pos, vals = (got[0], got[1]) if final else (got[0], None)
    if vals is None:  # the pass's uh, from the plain push
        vals = cuda_sheath._push_plain(args[0], args[1], args[2], args[3],
                                       args[4], args[6], SHEATH_DT, SHEATH_DX)[3]
    ref64 = cuda_sheath.sheath_deposit_plain(
        pos.double(), vals.double(), act1.double(), args[5].double(), ng, **kw)
    _rel_close(ref[-1], got[-1], 5e-5)
    _rel_close(ref64, got[-1], 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.5])
@pytest.mark.parametrize("n", N_SHEATH)
def test_sheath_reinject_kernel_matches_plain(cuda_device, n, gamma):
    """The thermostat + re-injection kernel against its plain version on
    the card: the Philox uniforms bit-equal; positions bit-equal; the
    velocities within 1e-6 of the largest (libdevice's logf/sinf/cosf
    against PyTorch's); held rows bit-equal to their inputs."""
    from pypic_tpu_torch.ops import cuda_rng

    rng = np.random.default_rng(8)
    p = rng.uniform(0, 50, n).astype(np.float32)
    v = rng.normal(0, 1e5, (3, n)).astype(np.float32)
    act = rng.choice(np.asarray([1.0, 0.0, -1.0], np.float32), n, p=[0.8, 0.1, 0.1])
    sig = np.where(rng.uniform(size=n) < 0.5, 1.3e6, 3.1e4).astype(np.float32)
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in (p, v[0], v[1], v[2], act, sig, 0.5 * sig)]
    key, step = (5, 6), 9
    u = cuda_rng.sheath_uniforms(key, step, n, gamma=gamma, device=cuda_device)
    assert torch.equal(u.cpu(), cuda_rng.sheath_uniforms(key, step, n, gamma=gamma,
                                                         device="cpu"))
    before = cuda_cic.LAUNCHES["sheath_reinject"]
    got = cuda_rng.sheath_reinject(key, step, *arrs, cells=50.0, gamma=gamma)
    assert cuda_cic.LAUNCHES["sheath_reinject"] == before + 1
    ref = cuda_rng.sheath_reinject_plain(key, step, *arrs, cells=50.0, gamma=gamma)
    assert torch.equal(got[0], ref[0])
    for r, g in zip(ref[1:], got[1:]):
        _rel_close(r, g, 1e-6)
    held = arrs[4] == 1.0
    if gamma > 0.0:
        held &= ~(u[5] < gamma)
    for g, a in zip(got, arrs[:4]):
        assert torch.equal(g[held], a[held])


def _offset_view(t):
    """t copied into a buffer one float in: a contiguous view that is not
    16-B aligned (the kernels' row-by-row path)."""
    buf = torch.empty(t.shape[0] + 1, dtype=t.dtype, device=t.device)
    view = buf[1:]
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


def _row_mix(n, seed=11, lost=109):
    """The configs[2] row's statuses: act = 1 but for ``lost`` rows at
    seeded random places, half at 0 and half at -1 (phase 18: ~109 wall
    losses a step at n = 1e6)."""
    rng = np.random.default_rng(seed)
    act = np.ones(n, np.float32)
    rows = rng.choice(n, lost, replace=False)
    act[rows[: lost // 2]] = 0.0
    act[rows[lost // 2:]] = -1.0
    return act


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("gamma", [0.0, 0.5])
@pytest.mark.parametrize("n", [1_000_000, 1_000_003])
def test_sheath_reinject_at_the_rows_mix(cuda_device, n, gamma, layout):
    """The re-injection at the configs[2] row's status mix (109 lost rows
    in n), at n = 1e6 and 1,000,003, on aligned inputs and on views one
    float in (the engine hands it views of (k, n) buffers): uniforms and
    positions bit-equal to the plain version's, velocities within 1e-6 of
    the largest, held rows bit-equal to their inputs; the outputs are
    contiguous 16-B aligned views."""
    from pypic_tpu_torch.ops import cuda_rng

    rng = np.random.default_rng(12)
    p = rng.uniform(0, 50, n).astype(np.float32)
    v = rng.normal(0, 1e5, (3, n)).astype(np.float32)
    sig = np.where(rng.uniform(size=n) < 0.5, 1.3e6, 3.1e4).astype(np.float32)
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in (p, v[0], v[1], v[2], _row_mix(n), sig, 0.5 * sig)]
    if layout == "offset":
        arrs = [_offset_view(a) for a in arrs]
    key, step = (7, 1), 422
    u = cuda_rng.sheath_uniforms(key, step, n, gamma=gamma, device=cuda_device)
    assert torch.equal(u.cpu(), cuda_rng.sheath_uniforms(key, step, n, gamma=gamma,
                                                         device="cpu"))
    got = cuda_rng.sheath_reinject(key, step, *arrs, cells=50.0, gamma=gamma)
    ref = cuda_rng.sheath_reinject_plain(key, step, *arrs, cells=50.0, gamma=gamma)
    for g in got:
        assert g.is_contiguous() and g.data_ptr() % 16 == 0
    assert torch.equal(got[0], ref[0])
    for r, g in zip(ref[1:], got[1:]):
        _rel_close(r, g, 1e-6)
    held = arrs[4] == 1.0
    if gamma > 0.0:
        held &= ~(u[5] < gamma)
    assert int((~held).sum()) >= 109
    for g, a in zip(got, arrs[:4]):
        assert torch.equal(g[held], a[held])


@pytest.mark.cuda
@pytest.mark.parametrize("final", [False, True], ids=["picard", "finalize"])
@pytest.mark.parametrize("ng", [51, 11])
@pytest.mark.parametrize("n", [1_000_000, 1_000_003])
def test_sheath_pass_kernels_on_offset_views(cuda_device, n, ng, final):
    """The pass and the finalize on inputs one float in (not 16-B
    aligned: the kernel's row-by-row path) at n = 1e6 and 1,000,003: the
    positions, velocities and statuses bit-equal to the plain version's
    and to the aligned inputs' outputs, and the current bit-equal to the
    aligned inputs' (the order of its sums follows the launch shape, not
    the path); the outputs are contiguous 16-B aligned views."""
    from pypic_tpu_torch.ops import cuda_sheath

    args = _sheath_inputs(n, ng, cuda_device)
    kw = dict(dt=SHEATH_DT, dx=SHEATH_DX)
    fn = cuda_sheath.sheath_finalize if final else cuda_sheath.sheath_picard
    plain = (cuda_sheath.sheath_finalize_plain if final
             else cuda_sheath.sheath_picard_plain)
    aligned = fn(*args, **kw)
    offset = fn(*[_offset_view(a) for a in args], **kw)
    ref = plain(*args, **kw)
    for g, a, r in zip(offset[:-1], aligned[:-1], ref[:-1]):
        assert g.is_contiguous() and g.data_ptr() % 16 == 0
        assert torch.equal(g, a) and torch.equal(g, r)
    assert torch.equal(offset[-1], aligned[-1])
    _rel_close(ref[-1], offset[-1], 5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("final", [False, True], ids=["picard", "finalize"])
@pytest.mark.parametrize("ng", [1760, 1761, 65_536])
def test_sheath_pass_at_its_ceiling(cuda_device, ng, final):
    """The pass and the finalize at the small mode's ceiling (32 thread
    columns a block, ng = 1,760) and in the large mode above it (int64
    fixed-point sums; the field in device memory at 65,536): the current
    bit-equal from call to call and within 2e-5 of a float64 deposit, the
    outputs bit-equal to the plain version's, one launch counted a call;
    LARGE_MAX_NG + 1 nodes raise naming the limit and launch nothing."""
    from pypic_tpu_torch.ops import cuda_sheath

    n = 200_003
    assert (ng > cuda_sheath.MAX_NG) == (ng > 1760)
    args = _sheath_inputs(n, ng, cuda_device)
    kw = dict(dt=SHEATH_DT, dx=SHEATH_DX)
    fn = cuda_sheath.sheath_finalize if final else cuda_sheath.sheath_picard
    plain = (cuda_sheath.sheath_finalize_plain if final
             else cuda_sheath.sheath_picard_plain)
    name = "sheath_finalize" if final else "sheath_picard"
    before = cuda_cic.LAUNCHES[name]
    got = fn(*args, **kw)
    assert torch.equal(fn(*args, **kw)[-1], got[-1])
    assert cuda_cic.LAUNCHES[name] == before + 2
    ref = plain(*args, **kw)
    for g, r in zip(got[:-1], ref[:-1]):
        assert torch.equal(g, r)
    x1, u1, xh, uh, _ = cuda_sheath._push_plain(
        args[0], args[1], args[2], args[3], args[4], args[6], SHEATH_DT, SHEATH_DX)
    pos, vals = (x1, u1) if final else (xh, uh)
    ref64 = cuda_sheath.sheath_deposit_plain(
        pos.double(), vals.double(), got[-2].double(), args[5].double(), ng, **kw)
    _rel_close(ref64, got[-1], 2e-5)
    before = dict(cuda_cic.LAUNCHES)
    es = torch.zeros(cuda_sheath.LARGE_MAX_NG + 1, dtype=torch.float32,
                     device=cuda_device)
    with pytest.raises(ValueError, match="LARGE_MAX_NG"):
        fn(es, *args[1:], **kw)
    assert cuda_cic.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "composed"])
def test_sheath_step_card_matches_cpu_at_ng_8192(cuda_device, backend):
    """test_sheath_step_card_matches_cpu at ng = 8,192 (the pass's and
    deposit_det's large mode, the field in shared memory), n = 200,000
    (~24 rows a cell), from the card's state after 3 steps: the same
    limits (Picard counts by floor_exit_counts_agree, wall losses and
    statuses equal, active positions within 1e-4 cells, e, j and phi
    within 1e-4 of their largest, the exit histograms equal)."""
    import dataclasses

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.diagnostics import floor_exit_counts_agree
    from pypic_tpu_torch.engines import sheath
    from pypic_tpu_torch.runner import run

    pre = presets.sheath_dd(n=200_000, ng=8192, device=cuda_device)
    cfg = dataclasses.replace(pre.config, backend=backend,
                              record_exit_after_step=0,
                              picard_init="extrapolate", picard_accel="anderson")
    st, _ = run(sheath.make_step(cfg), pre.state, 3)
    d = interop.sheath_state_to_numpy(st)
    (sc, mc), (sg, mg) = [sheath.make_step(cfg)(interop.sheath_state_from_numpy(d, dev))
                          for dev in ("cpu", cuda_device)]
    ok, line = floor_exit_counts_agree(
        mc.picard_iters, float(mc.picard_residual), mg.picard_iters,
        float(mg.picard_residual), d["e"], sc.e, tol=cfg.tol,
        tol_floor=cfg.tol_floor)
    assert ok, line
    assert int(mg.n_lost_left) == int(mc.n_lost_left)
    assert int(mg.n_lost_right) == int(mc.n_lost_right)
    assert torch.equal(sg.active.cpu(), sc.active)
    act = sc.active == 1
    assert float((sg.p.cpu()[act] - sc.p[act]).abs().max()) < 1e-4
    for a, b in ((sc.e, sg.e), (sc.j, sg.j), (mc.phi, mg.phi)):
        _rel_close(a, b.cpu(), 1e-4)
    assert torch.equal(sg.exit_hist.cpu(), sc.exit_hist)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True], ids=["bounded", "periodic"])
@pytest.mark.parametrize("ng", [29_057, 65_536])
def test_deposit2_large_mode_matches_plain(cuda_device, ng, periodic):
    """deposit2 above its columns' ceiling (29,056; global float atomics):
    at n = 999,996 (wide) and 16,384 (narrow), both deposits within 5e-5
    of the plain version and 2e-5 of a float64 deposit (the limits of
    test_deposit2_kernel_matches_plain), one launch counted."""
    for n in (999_996, 16_384):
        _, p, vx, vy, _, _, act = _mag_inputs(n, cuda_device, ng=ng)
        va, vb = vx * act, vy.abs() * act
        assert cuda_cic.deposit_launch_shape(n, ng, False, 132).cols == 0
        before = cuda_cic.LAUNCHES["deposit2"]
        a, b = cuda_cic.deposit2(p, va, vb, ng, periodic=periodic)
        assert cuda_cic.LAUNCHES["deposit2"] == before + 1
        ra, rb = cuda_cic.deposit2_plain(p, va, vb, ng, periodic=periodic)
        da, db = cuda_cic.deposit2_plain(p.double(), va.double(), vb.double(),
                                         ng, periodic=periodic)
        for got, ref, ref64 in ((a, ra, da), (b, rb, db)):
            _rel_close(ref, got, 5e-5)
            _rel_close(ref64, got, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("ng", [19_371, 29_057, 65_536])
def test_boris_gather_push_deposit_large_mode_matches_plain(cuda_device, ng, swap):
    """The carried sweep above its columns' ceiling (19,370; the field in
    shared memory up to FIELD_SMEM_MAX_NG, in device memory at 65,536), at n =
    999,996 (wide) and 16,384 (narrow): p1 and the velocities bit-equal to
    the plain version's, rho and n within 2e-5 of a float64 sum of its
    terms, the clamp count equal (the limits of
    test_boris_gather_push_deposit_kernel_matches_plain)."""
    for n in (999_996, 16_384):
        field, p, vx, vy, vz, const, act = _mag_inputs(n, cuda_device, ng=ng)
        act = act * ((p >= 0) & (p <= ng - 1)).float()
        args = (field, p, vx, vy, vz, const, act, act * 3.2, act * 1.5)
        kw = dict(b=(0.1395, 1.9951, 0.0), dt_dx=1e-10 / 2.5e-6, pad=2,
                  swap_weights=swap)
        before = cuda_cic.LAUNCHES["boris_gather_push_deposit"]
        got = cuda_cic.boris_gather_push_deposit(*args, **kw)
        assert cuda_cic.LAUNCHES["boris_gather_push_deposit"] == before + 1
        ref = cuda_cic.boris_gather_push_deposit_plain(*args, **kw)
        exact = cuda_cic.boris_gather_push_deposit_plain(
            *args, acc_dtype=torch.float64, **kw)
        for r, g in zip(ref[:4], got[:4]):
            assert torch.equal(r, g)
        for i in (4, 5):
            _rel_close(exact[i], got[i], 2e-5)
        assert int(got[6]) == int(ref[6])


@pytest.mark.cuda
def test_sheath_step_card_matches_cpu(cuda_device):
    """One fused step of sheath_dd (n = 12,000, the exit histograms
    recording) on the card and on the CPU from the same state after 5
    steps, the same Philox draws on both sides: equal Picard counts (or
    one apart at a step the first side left by the float32 floor exit,
    diagnostics.floor_exit_counts_agree), wall losses and
    statuses; active positions within 1e-4 cells, e, j and phi within 1e-4
    of their largest."""
    import dataclasses

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.engines import sheath
    from pypic_tpu_torch.runner import run

    pre = presets.sheath_dd(n=12_000, device="cpu")
    cfg = dataclasses.replace(pre.config, backend="fused",
                              record_exit_after_step=0,
                              picard_init="extrapolate", picard_accel="anderson")
    st, _ = run(sheath.make_step(cfg), pre.state, 5)
    d = interop.sheath_state_to_numpy(st)
    out = []
    for dev in ("cpu", cuda_device):
        s = interop.sheath_state_from_numpy(d, dev)
        out.append(sheath.make_step(cfg)(s))
    (sc, mc), (sg, mg) = out
    from pypic_tpu_torch.diagnostics import floor_exit_counts_agree

    ok, line = floor_exit_counts_agree(
        mc.picard_iters, float(mc.picard_residual), mg.picard_iters,
        float(mg.picard_residual), st.e, sc.e, tol=cfg.tol,
        tol_floor=cfg.tol_floor)
    assert ok, line
    assert int(mg.n_lost_left) == int(mc.n_lost_left)
    assert int(mg.n_lost_right) == int(mc.n_lost_right)
    assert torch.equal(sg.active.cpu(), sc.active)
    act = sc.active == 1
    assert float((sg.p.cpu()[act] - sc.p[act]).abs().max()) < 1e-4
    for a, b in ((sc.e, sg.e), (sc.j, sg.j), (mc.phi, mg.phi)):
        _rel_close(a, b.cpu(), 1e-4)
    assert torch.equal(sg.exit_hist.cpu(), sc.exit_hist)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True], ids=["bounded", "periodic"])
def test_deterministic_deposit_matches_plain(cuda_device, periodic):
    """The deterministic deposit: the same bits from call to call (its
    scratch reused), one launch counted a call, within 2e-5 of a float64
    deposit of the same values, and within 5e-5 of the atomics deposit."""
    n, ng = 1_000_003, 51
    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.uniform(0, ng - 1, n).astype(np.float32)).to(cuda_device)
    vals = torch.from_numpy(rng.normal(0, 1e3, n).astype(np.float32)).to(cuda_device)
    before = cuda_cic.LAUNCHES["deposit_det"]
    a = cuda_cic.deposit_det(p, vals, ng, periodic=periodic)
    b = cuda_cic.deposit_det(p, vals, ng, periodic=periodic)
    assert cuda_cic.LAUNCHES["deposit_det"] == before + 2
    assert torch.equal(a, b)
    _rel_close(cuda_cic.deposit_plain(p.double(), vals.double(), ng,
                                      periodic=periodic), a, 2e-5)
    _rel_close(cuda_cic.deposit(p, vals, ng, periodic=periodic), a, 5e-5)
    # a view one float in (4-B loads) sums the same rows in the same order
    pv = torch.cat([p.new_zeros(1), p])[1:]
    vv = torch.cat([vals.new_zeros(1), vals])[1:]
    assert torch.equal(cuda_cic.deposit_det(pv, vv, ng, periodic=periodic), a)
    # the exit histograms' shape: 2 x 64 bins, integer positions, 1% hits
    idx = torch.from_numpy(rng.integers(0, 128, n).astype(np.float32)).to(cuda_device)
    hits = torch.from_numpy((rng.uniform(size=n) < 0.01).astype(np.float32)).to(cuda_device)
    h = cuda_cic.deposit_det(idx, hits, 128, periodic=False)
    assert torch.equal(h, cuda_cic.deposit_det(idx, hits, 128, periodic=False))
    assert torch.equal(h.cpu(), cuda_cic.deposit_plain(idx.cpu(), hits.cpu(), 128,
                                                       periodic=False))


# ---------------------------------------------------------------------------
# the D-N Newton kernel, the tagged Philox draws, the D-N and GC steps and
# the card's size limits
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [800, 600, 257, 3, 31, 33, 1024])
def test_boltzmann_dn_kernel_matches_plain(cuda_device, ng):
    """The D-N Newton kernel against its plain version
    (tests/test_pallas.py:361-389's cases and criteria): iterations within
    one cold and equal warm, phi within 5e-4 of max|phi|, residual <= tol;
    one launch counted; n0 as a device tensor; the edge shapes as in the
    D-D test."""
    from pypic_tpu_torch.ops import cuda_newton

    rng = np.random.default_rng(13 + ng)
    dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
    n = torch.from_numpy(dens.astype(np.float32)).to(cuda_device)
    n0 = torch.tensor(0.9e17, dtype=torch.float32, device=cuda_device)
    te, dx = 116000.0, 2e-5
    zero = torch.zeros(ng, dtype=torch.float32, device=cuda_device)
    before = cuda_cic.LAUNCHES["boltzmann_dn"]
    got = cuda_newton.boltzmann_dn(n, n0, te, dx, zero)
    assert cuda_cic.LAUNCHES["boltzmann_dn"] == before + 1
    ref = cuda_newton.boltzmann_dn_plain(n, n0, te, dx, zero)
    assert float(got.residual) <= 1e-3
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    _rel_close(ref.phi, got.phi, 5e-4)
    got_w = cuda_newton.boltzmann_dn(n, n0, te, dx, ref.phi)
    ref_w = cuda_newton.boltzmann_dn_plain(n, n0, te, dx, ref.phi)
    assert int(got_w.iterations) == int(ref_w.iterations)
    _rel_close(ref_w.phi, got_w.phi, 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, ng", [("dd", 600), ("dn", 800)])
def test_newton_kernels_long_solve_match_plain(cuda_device, kind, ng):
    """A long solve (tol 0, maxiter 64: the loop at the float32 floor,
    its shared copy of phi and its partial sums carried over many
    iterations) of either Newton kernel against its plain version: the
    same count, phi within the short solves' limits (3e-5 D-D, 5e-4
    D-N of max|phi|)."""
    from pypic_tpu_torch.ops import cuda_newton

    te, dx = 116000.0, 2e-5
    if kind == "dd":
        rng = np.random.default_rng(11 + ng)
        dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
        rho = torch.from_numpy((1.602e-19 * dens).astype(np.float32)).to(cuda_device)
        n0 = torch.tensor(1e17, dtype=torch.float32, device=cuda_device)
        got = cuda_newton.boltzmann_dirichlet(rho, n0, te, dx, tol=0.0, maxiter=64)
        ref = cuda_newton.boltzmann_dirichlet_plain(rho, n0, te, dx, tol=0.0, maxiter=64)
        tol = 3e-5
    else:
        rng = np.random.default_rng(13 + ng)
        dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
        n = torch.from_numpy(dens.astype(np.float32)).to(cuda_device)
        n0 = torch.tensor(0.9e17, dtype=torch.float32, device=cuda_device)
        zero = torch.zeros(ng, dtype=torch.float32, device=cuda_device)
        got = cuda_newton.boltzmann_dn(n, n0, te, dx, zero, tol=0.0, maxiter=64)
        ref = cuda_newton.boltzmann_dn_plain(n, n0, te, dx, zero, tol=0.0, maxiter=64)
        tol = 5e-4
    assert int(got.iterations) == int(ref.iterations)
    _rel_close(ref.phi, got.phi, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("ndraw, tag", [(8, 1), (3, 2)])
def test_philox_uniforms_kernel_matches_plain(cuda_device, ndraw, tag):
    """The tagged uniforms (flux: 8 a row, tag 1; gyro-phases: 3, tag 2)
    bit-equal to philox_uniforms_plain's at a ragged n."""
    from pypic_tpu_torch.ops import cuda_rng

    got = cuda_rng.philox_uniforms((4, 5), 6, 100_003, ndraw, tag,
                                   device=cuda_device)
    ref = cuda_rng.philox_uniforms((4, 5), 6, 100_003, ndraw, tag, device="cpu")
    assert torch.equal(got.cpu(), ref)


def _one_step_card_vs_cpu(pre, cfg, hooks, cuda_device):
    """One step from the CPU state after 3 steps on the CPU and the card,
    the same CPU-made draws replayed on both; returns the two results."""
    from pypic_tpu_torch import interop
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.runner import run

    st, _ = run(magnetized.make_step(cfg), pre.state, 3)
    d = interop.magnetized_state_to_numpy(st)
    sc = interop.magnetized_state_from_numpy(d, "cpu")
    cpu_hooks = hooks(sc)
    out = [magnetized.make_step(cfg, **cpu_hooks)(sc)]

    def on_card(f):
        def hook(step, n):
            x = f(step, n)
            if isinstance(x, dict):
                return {k: v.to(cuda_device) for k, v in x.items()}
            return x.to(cuda_device)
        return hook

    card = {k: on_card(f) for k, f in cpu_hooks.items()}
    out.append(magnetized.make_step(cfg, **card)(
        interop.magnetized_state_from_numpy(d, cuda_device)))
    return out


def _assert_mag_step_close(out):
    """tests/test_magnetized.py:461-489's limits: rho rtol 1e-4, phi rtol
    1e-3, positions rtol 2e-5, velocities rtol 2e-4, equal counts."""
    (sc, mc), (sg, mg) = out
    np.testing.assert_allclose(mg.rho.cpu().numpy(), mc.rho.numpy(), rtol=1e-4)
    np.testing.assert_allclose(mg.phi.cpu().numpy(), mc.phi.numpy(), rtol=1e-3,
                               atol=1e-8)
    act = sc.active.numpy() == 1
    np.testing.assert_allclose(sg.p.cpu().numpy()[act], sc.p.numpy()[act],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(sg.v.cpu().numpy()[act], sc.v.numpy()[act],
                               rtol=2e-4, atol=1.0)
    assert torch.equal(sg.active.cpu(), sc.active)
    assert int(mg.n_reactivated) == int(mc.n_reactivated)


@pytest.mark.cuda
def test_dn_step_card_matches_cpu(cuda_device):
    """One fused D-N step of dirichlet_neumann_test (n = 12,000, ng = 800:
    the D-N kernel on the card, its plain version on the CPU), the same
    flux draws on both sides: the single-step limits above."""
    import dataclasses

    from pypic_tpu_torch import presets, sources

    pre = presets.dirichlet_neumann_test(n=12_000, device="cpu")
    cfg = dataclasses.replace(pre.config, backend="fused", newton_backend="pallas")
    src = cfg.source

    def hooks(state):
        return {"source_draws": lambda step, n: sources.sample_flux_batch(
            state.rng, step, n, cfg.grid, src.ti, src.mass, vx=src.vx,
            gamma=cfg.flux_gamma, vx_pert=cfg.flux_vx_pert, device="cpu")}
    _assert_mag_step_close(_one_step_card_vs_cpu(pre, cfg, hooks, cuda_device))


@pytest.mark.cuda
def test_gc_step_card_matches_cpu(cuda_device):
    """One pic_iead_gc step (n = 12,000, composed) on the card and the
    CPU, the same source and gyro-phase draws: the single-step limits
    above."""
    import dataclasses

    from pypic_tpu_torch import presets, sources
    from pypic_tpu_torch.ops import cuda_rng

    pre = presets.pic_iead_gc(n_per_species=2000, device="cpu")
    cfg = dataclasses.replace(pre.config, newton_backend="pallas")
    src = cfg.source

    def hooks(state):
        return {
            "source_draws": lambda step, n: sources.sample_source_batch(
                state.rng, step, n, cfg.grid, src.ti, src.mass, vx=src.vx,
                device="cpu"),
            "gyro_draws": lambda step, n: cuda_rng.philox_uniforms(
                state.rng, step, n, 3, cuda_rng.GYRO_TAG, device="cpu").t()}
    _assert_mag_step_close(_one_step_card_vs_cpu(pre, cfg, hooks, cuda_device))


@pytest.mark.cuda
def test_wrappers_raise_above_the_cards_limits(cuda_device):
    """On CUDA tensors the size limits hold (the CPU route runs any size):
    every particle kernel with a large mode raises only above LARGE_MAX_NG
    (the thirteen grid-stride and single-deposit rows, deposit_det, the
    sheath pass, deposit2, the carried Boris deposit), explicit_cycle
    above its 14,511 nodes of shared memory (its ticket's 16 static bytes
    counted); nothing is launched. The
    Newton kernels run above their one CTA's 1,024 rows (one launch of the
    large path each) and raise only above the large path's
    LARGE_MAX_ROWS."""
    from pypic_tpu_torch.ops import cuda_domain, cuda_newton, cuda_sheath

    def z(k):
        return torch.zeros(k, dtype=torch.float32, device=cuda_device)

    p, big = z(64), cuda_cic.SMEM_LIMIT // 4 + 1
    before = dict(cuda_cic.LAUNCHES)
    cycle = (cuda_cic.SMEM_LIMIT - 256 - 16) // 16 + 1
    with pytest.raises(ValueError, match="shared memory"):
        cuda_cic.explicit_cycle(z(cycle), p, p, cycle, qm=QM, w=W, dt=DT, dx=DX)
    big_ng = cuda_cic.LARGE_MAX_NG + 1
    f, kw = z(big_ng), dict(qm=QM, w=W, dt=DT, dx=DX)
    slab = dict(qm=QM, dt=DT, dx=DX, lo=2.0, hi=float(big_ng - 3))
    calls = [
        lambda: cuda_cic.picard_iteration(f, p, p, p, big_ng, **kw),
        lambda: cuda_cic.picard_iteration_shared(f, p, p, p, big_ng, **kw),
        lambda: cuda_cic.picard_finalize_nodep(f, p, p, p, big_ng, qm=QM, dt=DT, dx=DX),
        lambda: cuda_cic.picard_finalize(f, p, p, p, big_ng, **kw),
        lambda: cuda_cic.deposit(p, p, big_ng, periodic=True),
        lambda: cuda_cic.gather(f, p, periodic=False),
        lambda: cuda_cic.leapfrog_gather_push_deposit(f, p, p, **kw),
        lambda: cuda_cic.boris_gather_push(f, p, p, p, p, p, p, b=(0.0, 1.0, 0.0),
                                           dt_dx=1.0),
        lambda: cuda_domain.picard_iteration_ext(f, p, p, p, p, **slab),
        lambda: cuda_domain.picard_finalize_ext(f, p, p, p, p, lo_shift=0.0, ng=0, **slab),
        lambda: cuda_domain.picard_finalize_ext_nodep(f, p, p, p, p, lo_shift=0.0, ng=0,
                                                      **slab),
        lambda: cuda_domain.leapfrog_gather_push(f, p, p, qm=QM, dt=DT, dx=DX),
        lambda: cuda_domain.explicit_domain_cycle(f, p, p, p, qm=QM, dt=DT, dx=DX,
                                                  lo_shifted=0.0, ext_n=64),
        lambda: cuda_cic.deposit_det(p, p, big_ng, periodic=False),
        lambda: cuda_sheath.sheath_picard(f, p, p, p, p, p, p, dt=1e-12, dx=1e-5),
        lambda: cuda_cic.deposit2(p, p, p, big_ng, periodic=False),
        lambda: cuda_cic.boris_gather_push_deposit(f, p, p, p, p, p, p, p, p,
                                                   b=(0.0, 1.0, 0.0), dt_dx=1.0),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="LARGE_MAX_NG"):
            call()
    with pytest.raises(ValueError, match="at most"):
        cuda_newton.boltzmann_dirichlet(z(cuda_newton.LARGE_MAX_ROWS + 1), 1e17,
                                        1.16e5, 2e-5)
    assert cuda_cic.LAUNCHES == before
    dd = cuda_newton.boltzmann_dirichlet(z(1025), 1e17, 1.16e5, 2e-5)
    dn = cuda_newton.boltzmann_dn(z(1025), 1e17, 1.16e5, 2e-5, z(1025))
    assert bool(torch.isfinite(dd.phi).all() & torch.isfinite(dn.phi).all())
    for name in ("boltzmann_dirichlet", "boltzmann_dn"):
        assert cuda_cic.LAUNCHES[f"{name}_large"] == before[f"{name}_large"] + 1
        assert cuda_cic.LAUNCHES[name] == before[name]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_magnetized_auto_above_1024_nodes_launches_the_kernel(cuda_device,
                                                              backend):
    """newton_backend 'auto' (and 'pallas') at ng = 1200 on the card
    launches the large D-D Newton kernel once a step, takes no Thomas
    solve (THOMAS_SOLVES stays as it was), and phi converges."""
    import dataclasses

    from pypic_tpu_torch import presets
    from pypic_tpu_torch.engines import magnetized

    pre = presets.pic_iead(n_per_species=500, ng=1200, device=cuda_device)
    before = dict(magnetized.THOMAS_SOLVES)
    launches = dict(cuda_cic.LAUNCHES)
    _, m = magnetized.make_step(dataclasses.replace(
        pre.config, newton_backend=backend))(pre.state)
    assert magnetized.THOMAS_SOLVES == before
    assert (cuda_cic.LAUNCHES["boltzmann_dirichlet_large"]
            == launches["boltzmann_dirichlet_large"] + 1)
    assert cuda_cic.LAUNCHES["boltzmann_dirichlet"] == launches["boltzmann_dirichlet"]
    assert float(m.newton_residual) <= pre.config.newton_tol
    assert bool(torch.isfinite(m.phi).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [1025, 4098, 8000])
@pytest.mark.parametrize("name", ["boltzmann_dirichlet", "boltzmann_dn"])
def test_newton_large_path_matches_plain(cuda_device, name, ng):
    """The Newton solves above 1,024 rows (the large path: blocks of k
    rows a thread, the reduced PCR) against their plain versions on the
    same card tensors, 8 iterations (tol 0) and a converged solve: phi
    within 1e-5 of the largest |phi| (the chain kernel's tolerance, the
    same arithmetic with the products unfused), equal iteration counts on
    the fixed solve; one launch of the large path a call. The D-N row's
    grid at 8,000 nodes, the Neumann row inside a block at 4,098."""
    from pypic_tpu_torch.ops import cuda_newton

    rng = np.random.default_rng(ng)
    dens = (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15)
    if name == "boltzmann_dirichlet":
        rho = torch.from_numpy((1.602e-19 * dens).astype(np.float32)).to(cuda_device)
        args = (rho, 1e17, 1.16e5, 2e-5)
    else:
        n = torch.from_numpy(dens.astype(np.float32)).to(cuda_device)
        args = (n, 0.9e17, 1.16e5, 2e-5, torch.zeros_like(n))
    wrapper = getattr(cuda_newton, name)
    plain = getattr(cuda_newton, f"{name}_plain")
    for kw in (dict(tol=0.0, maxiter=8), {}):
        before = cuda_cic.LAUNCHES[f"{name}_large"]
        got = wrapper(*args, **kw)
        assert cuda_cic.LAUNCHES[f"{name}_large"] == before + 1
        ref = plain(*args, **kw)
        scale = float(ref.phi.abs().max())
        assert float((got.phi - ref.phi).abs().max()) <= 1e-5 * scale
        if kw:
            assert int(got.iterations) == int(ref.iterations) == 8


# --- the domain engines' kernels (ops/cuda_domain.py, csrc/domain.cu) ---
# a middle rank's slab of tests/test_torch_domain_kernels.py: c = 32,
# halo 4, ext_n = 45, positions past both clamp bounds, 10% dead slots
EXT_C, EXT_HALO = 32, 4
EXT_HW = EXT_HALO + 2
EXT_N = EXT_C + 2 * EXT_HW + 1
EXT_LO, EXT_HI = float(EXT_HW - EXT_HALO), float(EXT_C + EXT_HALO + EXT_HW)


def _slab_inputs(dev, n=12_007, seed=3):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(EXT_LO - 3, EXT_HI + 3, n).astype(np.float32)
    ps = (p0 + rng.normal(size=n) * 0.3).astype(np.float32)
    v0 = (rng.normal(size=n) * 1e5).astype(np.float32)
    field = (rng.normal(size=EXT_N) * 30.0).astype(np.float32)
    w = np.full(n, W, np.float32)
    w[rng.random(n) < 0.1] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (field, ps, p0, v0, w)]


def _slab_kw():
    return dict(qm=float(np.float32(QM)), dt=DT, dx=DX, lo=EXT_LO, hi=EXT_HI)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("emit_v", [False, True])
def test_picard_iteration_ext_kernel_matches_plain(cuda_device, emit_v, shared):
    """Raw midpoints and v1 as the plain version's (the same float32
    operations), jh within 1e-6 of a float64 sum of the plain terms, the
    clamp count equal; a pass with active = 0 writes nothing."""
    from pypic_tpu_torch.ops import cuda_domain

    args = _slab_inputs(cuda_device)
    kw = dict(emit_v=emit_v, shared=shared, **_slab_kw())
    before = cuda_cic.LAUNCHES["picard_iteration_ext"]
    got = cuda_domain.picard_iteration_ext(*args, **kw)
    assert cuda_cic.LAUNCHES["picard_iteration_ext"] == before + 1
    cpu = [a.cpu() for a in args]
    ref = cuda_domain.picard_iteration_ext_plain(*cpu, **kw)
    exact = cuda_domain.picard_iteration_ext_plain(
        *cpu, acc_dtype=torch.float64, **kw)
    _rel_close(ref[0], got[0], 1e-6)
    if emit_v:
        _rel_close(ref[1], got[1], 1e-6)
    jh = 1 + emit_v
    _rel_close(exact[jh], got[jh], 1e-6)
    if shared:
        assert int(got[-1]) == int(ref[-1])
    buf = args[1].clone()
    off = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    out = cuda_domain.picard_iteration_ext(
        args[0], buf, *args[2:], out=(buf, got[1] if emit_v else None),
        active=off, **kw)
    assert torch.equal(buf, args[1]) and not out[jh].any()


@pytest.mark.cuda
@pytest.mark.parametrize("deposit", [False, True])
def test_picard_finalize_ext_kernels_match_plain(cuda_device, deposit):
    """Global wrapped p1 and v1 as the plain version's, the statistics
    within 1e-6 (count exact) and bit-equal from call to call (fixed-order
    sums), j1 within 1e-6 of a float64 deposit."""
    from pypic_tpu_torch.ops import cuda_domain

    args = _slab_inputs(cuda_device)
    kw = dict(lo_shift=float(EXT_C - EXT_HW), ng=128, **_slab_kw())
    fn = (cuda_domain.picard_finalize_ext if deposit
          else cuda_domain.picard_finalize_ext_nodep)
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    assert torch.equal(got[-1], again[-1])
    cpu = [a.cpu() for a in args]
    ref = cuda_domain.picard_finalize_ext_plain(*cpu, deposit=deposit, **kw)
    _pos_close(ref[0], got[0].cpu(), 128, 1e-5)
    _rel_close(ref[1], got[1], 1e-6)
    st, st_ref = got[-1].cpu(), ref[-1]
    assert torch.allclose(st[:2], st_ref[:2], rtol=1e-6, atol=0)
    assert st[2] == st_ref[2] > 0
    if deposit:
        exact = cuda_domain.picard_finalize_ext_plain(
            *cpu, deposit=True, acc_dtype=torch.float64, **kw)[2]
        _rel_close(exact, got[2], 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 200])
def test_leapfrog_gather_push_kernel_matches_plain(cuda_device, ng):
    from pypic_tpu_torch.ops import cuda_domain

    e, _, p, v = _inputs(ng, cuda_device)
    kw = dict(qm=float(np.float32(QM)), dt=DT, dx=DX)
    before = cuda_cic.LAUNCHES["leapfrog_gather_push"]
    got = cuda_domain.leapfrog_gather_push(e, p, v, **kw)
    assert cuda_cic.LAUNCHES["leapfrog_gather_push"] == before + 1
    ref = cuda_domain.leapfrog_gather_push_plain(e.cpu(), p.cpu(), v.cpu(), **kw)
    _pos_close(ref[0], got[0].cpu(), ng, 1e-5)
    _rel_close(ref[1], got[1], 1e-6)
    # at and past both ends of [0, ng) the kernel's wrap, mod ng folded
    # in, is the plain version's bit for bit
    f32 = np.float32
    edges = torch.tensor([0.0, ng, np.nextafter(f32(ng), f32(2 * ng)),
                          np.nextafter(f32(ng), f32(0)), -1e-6, -1e-30, -ng,
                          2 * ng - 1e-4, -0.5], dtype=torch.float32)
    z = torch.zeros(ng)
    ref = cuda_domain.leapfrog_gather_push_plain(z, edges, edges * 0, **kw)[0]
    got = cuda_domain.leapfrog_gather_push(
        z.to(cuda_device), edges.to(cuda_device), (edges * 0).to(cuda_device),
        **kw)[0]
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("lo_shifted", [-13.0, 187.0], ids=["one rank", "middle rank"])
def test_explicit_domain_cycle_kernel_matches_plain(cuda_device, lo_shifted):
    """The carried carrier's sweep at ng = 200 on a 227-node extended slab
    (c = 200, halo 13), positions spread past both ext edges, a tenth of
    the slots dead: p1 and v1 bit-equal to the plain version's, rho_ext
    within 1e-6 of a float64 sum of the plain terms, the clamp count
    equal; dead slots deposit nothing."""
    from pypic_tpu_torch.ops import cuda_domain

    ng, ext_n = 200, 227
    e, _, p, v = _inputs(ng, cuda_device)
    v = v * 40.0
    w = torch.full_like(p, W)
    w[torch.arange(N, device=cuda_device) % 10 == 3] = 0.0
    kw = dict(qm=float(np.float32(QM)), dt=DT, dx=DX, lo_shifted=lo_shifted,
              ext_n=ext_n)
    before = cuda_cic.LAUNCHES["explicit_domain_cycle"]
    got = cuda_domain.explicit_domain_cycle(e, p, v, w, **kw)
    assert cuda_cic.LAUNCHES["explicit_domain_cycle"] == before + 1
    ref = cuda_domain.explicit_domain_cycle_plain(e, p, v, w, **kw)
    exact = cuda_domain.explicit_domain_cycle_plain(
        e, p, v, w, acc_dtype=torch.float64, **kw)
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
    _rel_close(exact[2], got[2], 1e-6)
    assert int(got[3]) == int(ref[3]) > 0
    assert abs(float(exact[2].sum()) - float(w.double().sum())) <= 1e-6 * abs(
        float(w.double().sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["implicit", "explicit"])
def test_domain_one_rank_card_matches_cpu(cuda_device, engine):
    """configs[4]'s workload at n = 20,000 on a one-rank mesh, 3 steps on
    the card (the fused kernels) and on the CPU (their plain versions):
    the Picard counts equal, the energies within 1e-5."""
    from pypic_tpu_torch.parallel import domain, domain_implicit, make_mesh
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import domain as row

    gpu, cpu = make_mesh(device=cuda_device), make_mesh(device="cpu")
    if engine == "implicit":
        cfg, st = row.implicit_row(gpu, n=20_000, backend="fused")
        mod, keys = domain_implicit, ("e", "j", "e_prev", "e_prev2")
    else:
        cfg, st = row.explicit_row(gpu, n=20_000, push_backend="fused")
        mod, keys = domain, ("rho",)
    st_cpu = st.replace(**{k: getattr(st, k).cpu() for k in (
        "p", "v", "alive", "q", "m", "step") + keys})
    outs = [run(mod.make_step(cfg, mesh), s0, 3)[1]
            for mesh, s0 in ((gpu, st), (cpu, st_cpu))]
    g, c = outs
    for k in ("field_energy", "kinetic_energy"):
        _rel_close(getattr(c, k), getattr(g, k).cpu(), 1e-5)
    if engine == "implicit":
        assert torch.equal(g.picard_iters.cpu(), c.picard_iters)


def _bca_draw_hooks(state, cfg, dev):
    """The source table and ionization uniforms of ``state``'s next step,
    made on the CPU, as make_step hooks for the CPU and for ``dev``."""
    from pypic_tpu_torch import sources
    from pypic_tpu_torch.ops import cuda_rng

    src, grid = cfg.source, cfg.grid
    step, n = state.step_host, state.p.shape[0]
    table = sources.sample_source_batch(state.rng, step, n, grid, src.ti,
                                        src.mass, vx=src.vx, device="cpu")
    ion = cuda_rng.philox_uniforms(state.rng, step, n, 1, cuda_rng.ION_TAG,
                                   device="cpu")[0]
    cpu = dict(source_draws=lambda s, k: table, ion_draws=lambda s, k: ion)
    card = dict(source_draws=lambda s, k: {a: b.to(dev) for a, b in table.items()},
                ion_draws=lambda s, k: ion.to(dev))
    return cpu, card


@pytest.mark.cuda
def test_pic_bca_aps_step_card_matches_cpu(cuda_device):
    """The pic_bca_aps step ('auto' on the card: fused, the Newton kernel,
    the gather of the ionization density, two IEAD deposits) against its
    plain versions on the CPU from pic_bca_aps(ppc=20) seeded with 256
    neutral wall-born B rows (tools/bca.seeded_state), the same draws:
    the counts equal (impacts, escapes, re-activations; ionizations up to
    the straddling draws), active and charge states equal outside the
    ionization draws within 1e-5 (relative) of their probability (the
    card's deposit2 flushes with float atomics, so such a draw may decide
    either way: counted and excluded), rho within 1e-4, phi within 1e-3
    of their largest, the active rows' positions within rtol 2e-5 / atol
    1e-5 cells and velocities within rtol 2e-4 / atol 1 m/s (chip_smoke
    phase 14's limits), the histograms equal; one launch each of gather
    and philox_uniforms, two of deposit."""
    import dataclasses

    from pypic_tpu_torch import interop, presets
    from pypic_tpu_torch.constants import E_CHARGE
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.ops.ionization import coefficient_table, rate_matrix
    from pypic_tpu_torch.tools import bca as bca_tool

    pre = presets.pic_bca_aps(ppc=20, device="cpu")
    st = bca_tool.seeded_state(pre, 256, 16)
    cfg_cpu = dataclasses.replace(pre.config, backend="fused",
                                  newton_backend="pallas")
    hooks_cpu, hooks_card = _bca_draw_hooks(st, pre.config, cuda_device)
    sc, mc = magnetized.make_step(cfg_cpu, **hooks_cpu)(st)
    d = interop.magnetized_state_to_numpy(st)
    before = dict(cuda_cic.LAUNCHES)
    sg, mg = magnetized.make_step(pre.config, **hooks_card)(
        interop.magnetized_state_from_numpy(d, cuda_device))
    torch.cuda.synchronize()
    grew = {k: cuda_cic.LAUNCHES[k] - before[k] for k in before}
    assert grew["gather"] == 1 and grew["deposit"] == 2 and grew["deposit2"] == 1
    assert grew["boris_gather_push"] == 1 and grew["boltzmann_dirichlet"] == 1
    # the ionization draws within 1e-5 of their probability: the density
    # the step gathers (the deposit of the starting state) at the new
    # positions
    grid, n = cfg_cpu.grid, st.p.shape[0]
    on = st.active == 1
    _, n_dens = cuda_cic.deposit2(
        st.p, torch.where(on, st.charge_state * E_CHARGE * st.p2c / grid.dx, 0.0),
        torch.where(on, st.p2c / grid.dx, 0.0), grid.ng, periodic=False)
    table = coefficient_table(rate_matrix(cfg_cpu.species_z, cfg_cpu.te), grid.dx,
                              cfg_cpu.dt, torch.float32, "cpu")
    coef = table[st.species_idx.long(),
                 torch.clamp(st.charge_state.to(torch.int32), 0, 2).long()]
    prob = ((cic.gather(n_dens, sc.p, periodic=False) * 1e-10) ** 2 * coef
            / torch.clamp(st.p2c, min=1e-30)).double()
    u = hooks_cpu["ion_draws"](st.step_host, n).double()
    draws = on & (st.charge_state < cfg_cpu.max_charge_state) & (coef > 0) & (prob < 1)
    straddle = draws & ((u - prob).abs() <= 1e-5 * prob)
    n_straddle = int(straddle.sum())
    for k in ("n_hit_wall", "n_escaped", "n_reactivated", "n_impacts",
              "n_escape_rows", "n_active"):
        assert int(getattr(mg, k)) == int(getattr(mc, k)), k
    assert abs(int(mg.n_ionized) - int(mc.n_ionized)) <= n_straddle, n_straddle
    assert int(mc.n_ionized) > 0 and int(mc.n_escaped) > 0
    differ = ((sg.charge_state.cpu() != sc.charge_state)
              | (sg.active.cpu() != sc.active))
    assert int((differ & ~straddle).sum()) == 0, n_straddle
    for k in ("species_idx", "from_wall"):
        assert torch.equal(getattr(sg, k).cpu(), getattr(sc, k)), k
    _rel_close(mc.rho, mg.rho, 1e-4)
    _rel_close(mc.phi, mg.phi, 1e-3)
    act = (sc.active == 1) & ~straddle
    np.testing.assert_allclose(sg.p.cpu()[act].numpy(), sc.p[act].numpy(),
                               rtol=2e-5, atol=1e-5)
    for k in ("vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(sg, k).cpu()[act].numpy(),
                                   getattr(sc, k)[act].numpy(), rtol=2e-4, atol=1.0,
                                   err_msg=k)
    for k in ("iead", "iead_out"):
        assert torch.equal(getattr(sg, k).cpu(), getattr(sc, k)), k


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A card state after 3 steps of pic_bca_aps(ppc=20) saved and loaded
    into a card template: every field bit for bit, the tensors on the
    card, the key words and host step kept."""
    from pypic_tpu_torch import checkpoint, interop, presets
    from pypic_tpu_torch.engines import magnetized
    from pypic_tpu_torch.runner import run

    pre = presets.pic_bca_aps(ppc=20, device=cuda_device)
    st, _ = run(magnetized.make_step(pre.config), pre.state, 3)
    path = str(tmp_path / "card.npz")
    checkpoint.save(path, st, step=3)
    back, manifest = checkpoint.load(path, pre.state)
    assert manifest["step"] == 3 and back.step_host == 3 and back.rng == st.rng
    assert back.p.is_cuda and back.iead.is_cuda
    a, b = (interop.magnetized_state_to_numpy(x) for x in (st, back))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _cli_rows(outdir):
    import json

    with open(outdir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [
    ["two_stream", "--particles", "20000", "--plot-every", "5"],
    ["domain_explicit", "--particles", "100000", "--opt",
     "field_solve=distributed"],
], ids=["two_stream", "domain_explicit distributed"])
def test_cli_on_the_card_matches_cpu(cuda_device, tmp_path, argv):
    """``pypic_tpu_torch.cli run`` on the card against ``--device cpu``
    over 10 steps: the same files, and the field and kinetic energies at
    the 50-step card-against-CPU limits of chip_smoke.py's implicit check
    (1e-3, 1e-5: the deposits' float atomics part the runs)."""
    from pypic_tpu_torch.cli import main

    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = tmp_path / dev
        main(["run", *argv, "--steps", "10", "--checkpoint-every", "5",
              "--device", dev, "--outdir", str(out[dev])])
    files = [sorted(p.relative_to(out[dev]).as_posix()
                    for p in out[dev].rglob("*") if p.is_file())
             for dev in ("cuda", "cpu")]
    assert files[0] == files[1]
    card, cpu = _cli_rows(out["cuda"]), _cli_rows(out["cpu"])
    assert len(card) == len(cpu) == 10
    for key, rtol in (("field_energy", 1e-3), ("kinetic_energy", 1e-5)):
        np.testing.assert_allclose([r[key] for r in card],
                                   [r[key] for r in cpu], rtol=rtol)
    assert all(r.get("n_dropped", 0) == 0 for r in card)


@pytest.mark.cuda
def test_histograms_on_the_card_equal_the_plain_counts(cuda_device):
    """diagnostics' histograms through row 4's deposit kernel on the card
    (one lane column) against the plain version on the CPU: counts equal,
    they are integers; edges equal."""
    from pypic_tpu_torch import diagnostics

    rng = np.random.default_rng(4)
    p = torch.from_numpy(rng.uniform(-0.2, 2.2, 1_000_003).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 2.0, 1_000_003).astype(np.float32))
    before = cuda_cic.LAUNCHES["deposit"]
    got = diagnostics.phase_space_histogram(p.to(cuda_device), v.to(cuda_device),
                                            100, 50, (0.0, 2.0), (-8.0, 8.0))
    ref = diagnostics.phase_space_histogram(p, v, 100, 50, (0.0, 2.0), (-8.0, 8.0))
    for g, r in zip(got, ref):
        assert g.is_cuda
        assert torch.equal(g.cpu(), r)
    got = diagnostics.velocity_histogram(v.to(cuda_device), 200, (-8.0, 8.0))
    ref = diagnostics.velocity_histogram(v, 200, (-8.0, 8.0))
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert cuda_cic.LAUNCHES["deposit"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("seed, n, streams, offset", [
    (11, 999_996, 4, 0), (11, 999_996, 4, 999_996),
    (11, 180_001, 8, 2**32 - 90_000),
    (44, 1000, 2, 669_265 - 500)])  # a uniform that rounds to 1
def test_hash_batch_kernel_matches_plain(cuda_device, seed, n, streams, offset):
    """hash_batch (the 'hash' sampler) against its plain version on the
    CPU: the uniforms bit-equal (float32 arithmetic in the same order),
    the Box-Muller normals within 2e-6 of the largest (the kernel's
    log_unit, sqrt_pos and sincos_2pi against float64 functions), 0 where
    a uniform rounds to 1."""
    from pypic_tpu_torch.ops import cuda_rng

    before = cuda_cic.LAUNCHES["hash_batch"]
    got = cuda_rng.hash_batch(seed, n, streams, offset=offset, device=cuda_device)
    ref = cuda_rng.hash_batch(seed, n, streams, offset=offset, device="cpu")
    assert torch.equal(got.cpu(), ref)
    z = cuda_rng.hash_batch(seed, n, streams, offset=offset, normals=True,
                            device=cuda_device)
    assert bool(torch.isfinite(z).all())
    zr = cuda_rng.hash_normals_from_uniforms(ref)
    assert float((z.cpu() - zr).abs().max()) <= 2e-6 * float(zr.abs().max())
    assert cuda_cic.LAUNCHES["hash_batch"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 31, 33, 150, 600, 1024, 1025, 16384])
@pytest.mark.parametrize("ends", [(True, True), (True, False), (False, True),
                                  (False, False)])
def test_tridiag3_chain_kernel_matches_plain(cuda_device, c, ends):
    """tridiag3_chain (the slab Newton's local chain solve) against its
    plain version on the same card tensors: the three columns and the six
    interface scalars within 1e-5 of the largest |x| (the same PCR, the
    products unfused), at the chain's ends and inside it; one launch a
    call, of the large path above 1,024 rows (1,025 and 16,384)."""
    from pypic_tpu_torch.ops import cuda_newton

    rng = np.random.default_rng(c)
    d = (-2.0 - np.exp(rng.normal(0, 1.5, c)) * 20).astype(np.float32)
    dl, du, f = (rng.normal(0, 1, c).astype(np.float32) for _ in range(3))
    dl, d, du, f = (torch.from_numpy(a).to(cuda_device) for a in (dl, d, du, f))
    first, last = ends
    name = "tridiag3_chain" if c <= 1024 else "tridiag3_chain_large"
    before = dict(cuda_cic.LAUNCHES)
    x, g6 = cuda_newton.tridiag3_chain(dl, d, du, f, first=first, last=last)
    assert cuda_cic.LAUNCHES[name] == before[name] + 1
    assert sum(cuda_cic.LAUNCHES.values()) == sum(before.values()) + 1
    xr, gr = cuda_newton.tridiag3_chain_plain(dl, d, du, f, first=first,
                                              last=last)
    scale = float(xr.abs().max())
    assert float((x - xr).abs().max()) <= 1e-5 * scale
    assert float((g6 - gr).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_sheath_reinject_rank_tag_matches_plain(cuda_device, gamma):
    """The re-injection kernel at a slab rank's tag (counters (row, step,
    j, 1 << 16), parallel.domain_sheath's rank 1) against its plain
    version: positions bit-equal, velocities within 1e-6 of the largest;
    a stream apart from tag 0's."""
    from pypic_tpu_torch.ops import cuda_rng

    n = 100_003
    rng = np.random.default_rng(18)
    p = rng.uniform(0, 50, n).astype(np.float32)
    v = rng.normal(0, 1e5, (3, n)).astype(np.float32)
    act = rng.choice(np.asarray([1.0, 0.0, -1.0], np.float32), n, p=[0.8, 0.1, 0.1])
    sig = np.full(n, 3.1e4, np.float32)
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in (p, v[0], v[1], v[2], act, sig, 0.5 * sig)]
    key, step, tag = (5, 6), 9, 1 << 16
    got = cuda_rng.sheath_reinject(key, step, *arrs, cells=50.0, gamma=gamma,
                                   tag=tag)
    ref = cuda_rng.sheath_reinject_plain(key, step, *arrs, cells=50.0,
                                         gamma=gamma, tag=tag)
    assert torch.equal(got[0], ref[0])
    for r, g in zip(ref[1:], got[1:]):
        _rel_close(r, g, 1e-6)
    zero = cuda_rng.sheath_reinject(key, step, *arrs, cells=50.0, gamma=gamma)
    assert not torch.equal(zero[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("deposit", [False, True])
def test_picard_finalize_ext_raw_mode_matches_plain(cuda_device, deposit):
    """The finalize sweeps in the superstep's raw mode (lo_shift 0, ng 0:
    the position kept raw and shifted, as the micro-steps before the last
    run them): p1 and v1 within 1e-6 of the plain version's (no wrap at
    all: a position past either edge stays there), the statistics still
    accumulated (within 1e-6, the clamp count exact and > 0), j1 within
    1e-6 of a float64 deposit."""
    from pypic_tpu_torch.ops import cuda_domain

    args = _slab_inputs(cuda_device)
    kw = dict(lo_shift=0.0, ng=0, **_slab_kw())
    fn = (cuda_domain.picard_finalize_ext if deposit
          else cuda_domain.picard_finalize_ext_nodep)
    got = fn(*args, **kw)
    cpu = [a.cpu() for a in args]
    ref = cuda_domain.picard_finalize_ext_plain(*cpu, deposit=deposit, **kw)
    _rel_close(ref[0], got[0], 1e-6)
    _rel_close(ref[1], got[1], 1e-6)
    assert float(got[0].min()) < 0.0 or float(got[0].max()) > EXT_HI
    st, st_ref = got[-1].cpu(), ref[-1]
    assert torch.allclose(st[:2], st_ref[:2], rtol=1e-6, atol=0)
    assert st[2] == st_ref[2] > 0
    if deposit:
        exact = cuda_domain.picard_finalize_ext_plain(
            *cpu, deposit=True, acc_dtype=torch.float64, **kw)[2]
        _rel_close(exact, got[2], 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["scatter", "matmul"])
def test_deterministic_deposit_methods_repeat_bits(cuda_device, method):
    """deposit_method 'scatter' and 'matmul' take deposit_det: the same
    bits call after call, within 2e-5 of the deposit kernel, at ng = 51
    and in the large mode above the columns' ceiling (ng = 2,000 and
    65,536 at n = 1e6 and 1e7: int64 fixed-point sums, within 2e-5 of a
    float64 deposit); above LARGE_MAX_NG on the card they raise naming
    the limit."""
    e, ps, p0, v0 = _inputs(51, cuda_device)
    vals = v0 * 1e-5
    before = cuda_cic.LAUNCHES["deposit_det"]
    a = cic.deposit(p0 * (50.0 / 51.0), vals, 51, periodic=False, method=method)
    b = cic.deposit(p0 * (50.0 / 51.0), vals, 51, periodic=False, method=method)
    assert cuda_cic.LAUNCHES["deposit_det"] == before + 2
    assert torch.equal(a, b)
    ref = cic.deposit(p0 * (50.0 / 51.0), vals, 51, periodic=False)
    _rel_close(ref.cpu(), a, 2e-5)
    rng = np.random.default_rng(8)
    for n, ng in ((1_000_000, 2000), (10_000_000, 65_536)):
        p = torch.from_numpy(rng.uniform(0, ng - 1, n).astype(np.float32)).to(cuda_device)
        w = torch.from_numpy(rng.normal(0, 1e3, n).astype(np.float32)).to(cuda_device)
        a = cic.deposit(p, w, ng, periodic=False, method=method)
        assert torch.equal(a, cic.deposit(p, w, ng, periodic=False, method=method))
        _rel_close(cuda_cic.deposit_plain(p.double(), w.double(), ng,
                                          periodic=False), a, 2e-5)
    with pytest.raises(ValueError, match="LARGE_MAX_NG"):
        cic.deposit(p0, vals, cuda_cic.LARGE_MAX_NG + 1, periodic=False,
                    method=method)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["implicit", "explicit"])
def test_superstep_k1_on_the_card_matches_make_step(cuda_device, engine):
    """superstep(k=1) against make_step on the card, 3 steps of
    configs[4]'s workload at n = 20,000 on a one-rank mesh: the energies
    within 1e-5 (float atomics: not bit for bit), the counts equal, the
    step advanced by one a call."""
    from pypic_tpu_torch.parallel import domain, domain_implicit, make_mesh
    from pypic_tpu_torch.runner import run
    from pypic_tpu_torch.tools import domain as row

    mesh = make_mesh(device=cuda_device)
    if engine == "implicit":
        cfg, st = row.implicit_row(mesh, n=20_000, backend="fused")
        mod = domain_implicit
    else:
        cfg, st = row.explicit_row(mesh, n=20_000, push_backend="fused")
        mod = domain
    s1, m1 = run(mod.make_step(cfg, mesh), st, 3)
    s2, m2 = run(mod.make_superstep(cfg, mesh, 1), st, 3)
    assert m2.field_energy.shape == (3, 1) and int(s2.step) == 3
    for k in ("field_energy", "kinetic_energy"):
        _rel_close(getattr(m1, k).cpu(), getattr(m2, k).reshape(-1), 1e-5)
    for k in ("n_alive", "n_migrated", "n_dropped", "n_halo_clamped"):
        assert torch.equal(getattr(m1, k).cpu(),
                           getattr(m2, k).reshape(-1).cpu()), k


# the large modes of the periodic, explicit and slab kernels: each wrapper
# at 32,768 nodes (the global mode where the row's old ceiling lies below
# it, else the shared mode) and at 65,536 (the global mode), against its
# plain version
LARGE_ROWS = ["picard_iteration", "picard_iteration_shared", "picard_finalize_nodep",
              "picard_finalize", "deposit", "gather", "leapfrog_gather_push_deposit",
              "boris_gather_push", "picard_iteration_ext", "picard_finalize_ext",
              "picard_finalize_ext_nodep", "leapfrog_gather_push",
              "explicit_domain_cycle"]


def _large_row_call(name, ng, dev):
    """(the wrapper's call, the plain version's call) of one row on n =
    200,003 random inputs at ng nodes; the slab rows on an extended slab
    of ng nodes (halo 13), the domain cycle on one rank's whole grid."""
    from pypic_tpu_torch.ops import cuda_domain as KD

    n = 200_003
    gen = torch.Generator(device=dev).manual_seed(ng + len(name))
    f32 = torch.float32
    p0 = torch.rand(n, generator=gen, device=dev, dtype=f32) * ng
    ps = torch.remainder(p0 + torch.randn(n, generator=gen, device=dev) * 0.3, ng)
    v0 = torch.randn(n, generator=gen, device=dev, dtype=f32) * 1e5
    e = torch.randn(ng, generator=gen, device=dev, dtype=f32) * 1e3
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    if name in ("picard_iteration", "picard_iteration_shared", "picard_finalize"):
        fn = getattr(cuda_cic, name)
        plain = getattr(cuda_cic, name + "_plain")
        return (lambda: fn(e, ps, p0, v0, ng, **kw)), (lambda: plain(e, ps, p0, v0, ng, **kw))
    if name == "picard_finalize_nodep":
        fkw = dict(qm=QM, dt=DT, dx=DX)
        return ((lambda: cuda_cic.picard_finalize_nodep(e, ps, p0, v0, ng, **fkw)),
                (lambda: cuda_cic.picard_finalize_nodep_plain(e, ps, p0, v0, ng, **fkw)))
    if name == "deposit":
        return ((lambda: cuda_cic.deposit(p0, v0 * W, ng, periodic=True)),
                (lambda: cuda_cic.deposit_plain(p0, v0 * W, ng, periodic=True)))
    if name == "gather":
        return ((lambda: cuda_cic.gather(e, p0, periodic=True)),
                (lambda: cuda_cic.gather_plain(e, p0, periodic=True)))
    if name == "leapfrog_gather_push_deposit":
        return ((lambda: cuda_cic.leapfrog_gather_push_deposit(e, p0, v0, **kw)),
                (lambda: cuda_cic.leapfrog_gather_push_deposit_plain(e, p0, v0, **kw)))
    if name == "boris_gather_push":
        act = (torch.rand(n, generator=gen, device=dev) < 0.9).to(f32)
        const = torch.full((n,), 1e-4, device=dev)
        bkw = dict(b=(0.1, 2.0, 0.0), dt_dx=4e-5, swap_weights=True)
        args = (e, p0 * ((ng - 1) / ng), v0, v0 * 0.5, v0 * 0.25, const, act)
        return ((lambda: cuda_cic.boris_gather_push(*args, **bkw)),
                (lambda: cuda_cic.boris_gather_push_plain(*args, **bkw)))
    qm = float(torch.tensor(QM, dtype=torch.float32))
    w = torch.full((n,), W, device=dev)
    w[torch.rand(n, generator=gen, device=dev) < 0.05] = 0.0
    if name == "leapfrog_gather_push":
        lkw = dict(qm=qm, dt=DT, dx=DX)
        return ((lambda: KD.leapfrog_gather_push(e, p0, v0, **lkw)),
                (lambda: KD.leapfrog_gather_push_plain(e, p0, v0, **lkw)))
    if name == "explicit_domain_cycle":
        ckw = dict(qm=qm, dt=DT, dx=DX, lo_shifted=-13.0, ext_n=ng + 27)
        field = e * 0.03
        return ((lambda: KD.explicit_domain_cycle(field, p0, v0 * 5.0, w, **ckw)),
                (lambda: KD.explicit_domain_cycle_plain(field, p0, v0 * 5.0, w, **ckw)))
    hw = 15
    c = ng - 2 * hw - 1
    skw = dict(qm=qm, dt=DT, dx=DX, lo=2.0, hi=float(c + 28))
    p0s = p0 * ((c + 32.0) / ng) - 1.0
    args = (e * 0.03, p0s + 0.1, p0s, v0, w)
    if name == "picard_iteration_ext":
        return ((lambda: KD.picard_iteration_ext(*args, shared=True, **skw)),
                (lambda: KD.picard_iteration_ext_plain(*args, shared=True, **skw)))
    dep = name == "picard_finalize_ext"
    fkw = dict(skw, lo_shift=float(c - hw), ng=4 * c)
    fn = KD.picard_finalize_ext if dep else KD.picard_finalize_ext_nodep
    return ((lambda: fn(*args, **fkw)),
            (lambda: KD.picard_finalize_ext_plain(*args, deposit=dep, **fkw)))


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [32_768, 65_536])
@pytest.mark.parametrize("name", LARGE_ROWS)
def test_large_modes_match_plain(cuda_device, name, ng):
    """Every output against the plain version's: the (n,) outputs within
    1e-6 of their largest value (the same float32 operations; positions
    at p ~ ng differ by an ulp at most), the (ng,) deposits within 2e-5 of
    their largest node (float atomics in another order), counts equal;
    the launch in the mode ``smem_mode`` names (a large one at 65,536)."""
    call, plain = _large_row_call(name, ng, cuda_device)
    cuda_cic.reset_launch_counts()
    got, ref = call(), plain()
    torch.cuda.synchronize()
    modes = dict(cuda_cic.LARGE_LAUNCHES)
    assert cuda_cic.LAUNCHES[name] == 1
    if ng == 65_536:
        mode = "global"
        if name in cuda_cic.CLUSTER_KERNELS:  # rows 1, 2, 14, 17: cluster_launch's mode
            mode = cuda_cic.cluster_launch(name, 200_003, ng, 132).mode
        assert modes == {f"{name} {mode}": 1}
    _large_outputs_match(got, ref)


def _large_outputs_match(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if g.dim() == 0:  # a clamp count
            assert int(g) == int(r)
        elif g.dtype == torch.float64:  # the slab statistics, one by one
            for i in range(g.shape[0]):
                _rel_close(r[i:i + 1], g[i:i + 1], 1e-6)
        else:
            _rel_close(r, g, 1e-6 if g.shape[0] == 200_003 else 2e-5)


# the cluster and pair modes of rows 1 and 2 (csrc/cic.cu kCluster, kPair),
# forced at grids whose cluster slices of ceil(ng / C) nodes cut the rows'
# node pairs: C = 1 at 20,000, 2 at 65,536 and 100,003 (a shorter last
# slice), 4 at 116,225, 8 at 262,144 and 16 (a non-portable cluster) at
# 600,000
CLUSTER_NGS = [20_000, 65_536, 100_003, 116_225, 262_144, 600_000]


def _forced_pass(monkeypatch, mode):
    import functools

    monkeypatch.setattr(cuda_cic, "_pass_launch",
                        functools.partial(_PASS_LAUNCH, mode=mode))


_PASS_LAUNCH = cuda_cic._pass_launch


def _seam_rows(ng, item, dev, dtype):
    """n = 200,003 random rows, the first ones astride the slices' seams
    (r S - 1 and r S) and the grid's (ng - 1 and 0) with their midpoints,
    ps, p0 and v0 of ``dtype``, and a field."""
    n = 200_003
    gen = torch.Generator(device=dev).manual_seed(ng)
    c = cuda_cic.cluster_size("picard_iteration_shared", ng, item)
    s = -(-ng // c)
    seams = [r * s for r in range(1, c)] + [ng]
    at = torch.tensor([x - 1 + f for x in seams for f in (0.25, 0.75, 0.999)],
                      dtype=torch.float64)
    p0 = torch.rand(n, generator=gen, device=dev, dtype=torch.float64) * ng
    p0[:at.numel()] = at.to(dev)
    ps = p0.clone()
    v0 = torch.randn(n, generator=gen, device=dev, dtype=torch.float64) * 1e5
    v0[:at.numel()] = 0.0
    e = torch.randn(ng, generator=gen, device=dev, dtype=torch.float64) * 1e3
    return [x.to(dtype) for x in (e, ps, p0, v0)], c


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cluster", "pair"])
@pytest.mark.parametrize("ng", CLUSTER_NGS)
@pytest.mark.parametrize("name", ["picard_iteration", "picard_iteration_shared"])
def test_cluster_mode_matches_plain_and_global_bits(cuda_device, monkeypatch, name, ng,
                                                    mode):
    """Rows 1 and 2 forced into the cluster or pair mode on rows astride
    the cluster slices' seams and the grid's: ph, v1 and the clamp count
    bit-equal to the global mode's (the sweep is its code), jh within 2e-5
    of the plain version's largest node (float atomics in another order),
    one launch in the mode."""
    (e, ps, p0, v0), c = _seam_rows(ng, 4, cuda_device, torch.float32)
    kw = dict(qm=QM, w=W, dt=DT, dx=DX, emit_v=True)
    fn = getattr(cuda_cic, name)
    _forced_pass(monkeypatch, "global")
    glob = fn(e, ps, p0, v0, ng, **kw)
    _forced_pass(monkeypatch, mode)
    cuda_cic.reset_launch_counts()
    got = fn(e, ps, p0, v0, ng, **kw)
    ref = getattr(cuda_cic, name + "_plain")(e, ps, p0, v0, ng, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_cic.LARGE_LAUNCHES) == {f"{name} {mode}": 1}
    assert got[2].shape == (ng,)
    assert c == cuda_cic.cluster_launch(name, 200_003, ng, 132, mode="cluster").cluster
    for i in (0, 1) + ((3,) if name.endswith("shared") else ()):
        assert torch.equal(got[i], glob[i]), i
    _rel_close(ref[2], got[2], 2e-5)



# rows 17 and 14's cluster and pair modes (csrc/domain.cu, csrc/explicit.cu
# kCluster, kPair), forced at the rule's first node (16,384: C = 1) and at
# 65,536 (C = 2), on rows astride the slices' seam and at both ends of the
# slab (row 17; its shared window's l = -1 and ext_n - 1) or the wrap
# (row 14)
SWEEP_MODE_NGS = [16_384, 65_536]


def _slab_rows(ext_n, dev, seed=3):
    """n = 200,003 rows on an ext_n-node slab whose clamp bounds reach -1
    and ext_n - 0.5, the first ones at rest at the seams of the slices of
    C = cluster_size nodes and at both bounds, 5% dead slots; (field, ps,
    p0, v0, w), the bounds and C."""
    n = 200_003
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = -1.0, ext_n - 0.5
    c = cuda_cic.cluster_size("picard_iteration_ext shared", ext_n)
    s = -(-ext_n // c)
    at = torch.tensor([x - 1 + f for x in [r * s for r in range(1, c)] for f in (0.25, 0.75)]
                      + [lo + 0.5, lo + 0.75, hi - 0.25, hi - 0.1], device=dev)
    p0 = torch.rand(n, generator=gen, device=dev) * (hi - lo + 4.0) + (lo - 2.0)
    p0[:at.numel()] = at
    ps = p0 + torch.randn(n, generator=gen, device=dev) * 0.3
    ps[:at.numel()] = at
    v0 = torch.randn(n, generator=gen, device=dev) * 1e5
    v0[:at.numel()] = 0.0
    field = torch.randn(ext_n, generator=gen, device=dev) * 30.0
    w = torch.full((n,), W, device=dev)
    w[torch.rand(n, generator=gen, device=dev) < 0.05] = 0.0
    w[:at.numel()] = W
    return (field, ps, p0, v0, w), (lo, hi), c


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cluster", "pair"])
@pytest.mark.parametrize("ng", SWEEP_MODE_NGS)
@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
def test_slab_pass_modes_match_plain_and_global_bits(cuda_device, monkeypatch, shared, ng,
                                                     mode):
    """Row 17 forced into the cluster or pair mode: ph, v1 and the clamp
    count bit-equal to the global mode's (the sweep is its code), jh
    within 2e-5 of the plain version's largest node and of its twin's
    (float atomics in another order), one launch in the mode."""
    from pypic_tpu_torch.ops import cuda_domain

    args, (lo, hi), c = _slab_rows(ng, cuda_device)
    kw = dict(qm=float(np.float32(QM)), dt=DT, dx=DX, lo=lo, hi=hi, emit_v=True,
              shared=shared)
    _forced_pass(monkeypatch, "global")
    glob = cuda_domain.picard_iteration_ext(*args, **kw)
    _forced_pass(monkeypatch, mode)
    cuda_cic.reset_launch_counts()
    got = cuda_domain.picard_iteration_ext(*args, **kw)
    ref = cuda_domain.picard_iteration_ext_plain(*args, **kw)
    twin = cuda_domain.picard_iteration_ext_cluster_plain(*args, mode=mode, cluster=c, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_cic.LARGE_LAUNCHES) == {f"picard_iteration_ext {mode}": 1}
    assert got[2].shape == (ng,)
    for i in (0, 1) + ((3,) if shared else ()):
        assert torch.equal(got[i], glob[i]), i
    _rel_close(ref[2], got[2], 2e-5)
    _rel_close(twin[2], got[2], 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cluster", "pair"])
@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
def test_slab_pass_modes_skip_when_inactive(cuda_device, monkeypatch, shared, mode):
    """active = 0: the cluster mode's every CTA returns before its first
    cluster barrier and the pair mode's fold sums zeros, so the iterate
    keeps its content, jh is zero and the count 0; active = 1 then writes
    the pass."""
    from pypic_tpu_torch.ops import cuda_domain

    (field, ps, p0, v0, w), (lo, hi), _ = _slab_rows(65_536, cuda_device)
    kw = dict(qm=float(np.float32(QM)), dt=DT, dx=DX, lo=lo, hi=hi, shared=shared)
    _forced_pass(monkeypatch, mode)
    want = cuda_domain.picard_iteration_ext(field, ps, p0, v0, w, **kw)
    buf = ps.clone()
    off = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    got = cuda_domain.picard_iteration_ext(field, buf, p0, v0, w, out=(buf, None),
                                           active=off, **kw)
    torch.cuda.synchronize()
    assert torch.equal(buf, ps) and not got[1].any()
    assert not shared or int(got[2]) == 0
    got = cuda_domain.picard_iteration_ext(field, buf, p0, v0, w, out=(buf, None),
                                           active=off + 1, **kw)
    assert torch.equal(buf, want[0])
    _rel_close(want[1], got[1], 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cluster", "pair"])
@pytest.mark.parametrize("ng", SWEEP_MODE_NGS)
def test_leapfrog_deposit_modes_match_plain_and_global_bits(cuda_device, monkeypatch, ng,
                                                            mode):
    """Row 14 forced into the cluster or pair mode on rows whose new
    positions land astride the slices' seams and the wrap: p1 and v1
    bit-equal to the global mode's, rho within 2e-5 of the plain
    version's largest node and of its twin's, one launch in the mode."""
    (e, _, p0, v0), c = _seam_rows(ng, 4, cuda_device, torch.float32)
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    _forced_pass(monkeypatch, "global")
    glob = cuda_cic.leapfrog_gather_push_deposit(e, p0, v0, **kw)
    _forced_pass(monkeypatch, mode)
    cuda_cic.reset_launch_counts()
    got = cuda_cic.leapfrog_gather_push_deposit(e, p0, v0, **kw)
    ref = cuda_cic.leapfrog_gather_push_deposit_plain(e, p0, v0, **kw)
    twin = cuda_cic.leapfrog_gather_push_deposit_cluster_plain(e, p0, v0, mode=mode,
                                                               cluster=c, **kw)
    torch.cuda.synchronize()
    assert dict(cuda_cic.LARGE_LAUNCHES) == {f"leapfrog_gather_push_deposit {mode}": 1}
    assert got[2].shape == (ng,)
    assert torch.equal(got[0], glob[0]) and torch.equal(got[1], glob[1])
    _rel_close(ref[2], got[2], 2e-5)
    _rel_close(twin[2], got[2], 2e-5)

def _mode_boundaries(name, n, sms):
    """The last node of each launch shape of a large row and the first of
    the next, up to SMEM_LIMIT // 4 + 1 nodes: its sweep modes
    (sweep_launch; rows 1 and 2 cluster_launch's modes and cluster sizes)
    or, for the single deposit, its modes and columns."""
    if name == "deposit":
        keys = [lambda ng: (lambda s: (s.mode, s.cols))(
            cuda_cic.deposit_launch_shape(n, ng, False, sms, hists=1))]
    elif name in cuda_cic.CLUSTER_KERNELS:  # rows 1, 2, 14, 17: modes and cluster sizes
        keys = [(lambda k: lambda ng: (lambda s: (s.mode, s.cluster))(
            cuda_cic.cluster_launch(k, n, ng, sms)))(k)
            for k in cuda_cic.CLUSTER_KERNELS if k.split()[0] == name]
    else:
        def key(kernel):
            extra = (lambda ng: 4 * (ng + 27)) if name == "explicit_domain_cycle" else (
                lambda ng: 0)
            return lambda ng: cuda_cic.sweep_launch(kernel, n, ng, sms, extra(ng)).mode
        keys = [key(k) for k in cuda_cic.SWEEP_KERNELS if k.split()[0] == name]
    out = set()
    for key in keys:
        prev = key(2)
        for ng in range(3, cuda_cic.SMEM_LIMIT // 4 + 2):
            cur = key(ng)
            if cur != prev:
                out.update((ng - 1, ng))
            prev = cur
    return sorted(out)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LARGE_ROWS)
def test_large_rows_at_their_mode_boundaries(cuda_device, name):
    """Each large row at the last node of each of its launch shapes and the
    first of the next (the shared mode's last node, where its arrays and
    its kernel's static bytes fill a block, and the large mode's first;
    the single deposit's column counts too), against its plain version at
    test_large_modes_match_plain's limits: no launch is refused."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ngs = _mode_boundaries(name, 200_003, sms)
    assert ngs
    for ng in ngs:
        call, plain = _large_row_call(name, ng, cuda_device)
        _large_outputs_match(call(), plain())


@pytest.mark.cuda
def test_static_smem_within_the_launch_tables(cuda_device):
    """The compiler's report of the built library (ptxas -v) against the
    static bytes every launch shape counts (cuda_cic.check_static_smem):
    a kernel with more would ask for more than a block holds at its last
    shared node, as row 9 did at 58,112 nodes and deposit_det at 1,816."""
    from pypic_tpu_torch.ops import _build

    _, info = _build.load()
    assert "bytes smem" in info.log
    assert cuda_cic.check_static_smem(info.log) == []
