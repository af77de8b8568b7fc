"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode)
and skips without one.

The magnetized kernels run at n = 999,996 (bench.py's configs[3] row) and
a ragged n, ng = 600, with their tolerances stated beside each test.

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
from pypic_tpu_torch.ops import cuda_cic, fd, poisson
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
@pytest.mark.parametrize("n", [4097, 100_000, 131_072])
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


def _mag_inputs(n, dev, seed=3):
    """Bounded-grid particles with a tenth inactive, some off the grid
    (wall-lost slots) with weight 0."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, NG_MAG - 1, n).astype(np.float32)
    p[:4] = [0.0, NG_MAG - 1, -0.3, NG_MAG - 0.7]
    v = rng.normal(0, 2e4, (3, n)).astype(np.float32)
    act = (rng.uniform(size=n) < 0.9).astype(np.float32)
    act[2:4] = 0.0
    const = (rng.integers(1, 6, n) * (0.5 * 1e-10 * 1.602e-19 / 1.8e-26)).astype(np.float32)
    field = rng.normal(0, 1e5, NG_MAG).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (field, p, *v, const, act)]


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True], ids=["bounded", "periodic"])
@pytest.mark.parametrize("n", N_MAG)
def test_deposit2_kernel_matches_plain(cuda_device, n, periodic):
    """Both deposits against the plain version (float32, summed in another
    order: 5e-5 of the largest node) and against a float64 deposit of the
    same values (2e-5)."""
    _, p, vx, vy, _, _, act = _mag_inputs(n, cuda_device)
    va, vb = vx * act, vy.abs() * act
    before = cuda_cic.LAUNCHES["deposit2"]
    a, b = cuda_cic.deposit2(p, va, vb, NG_MAG, periodic=periodic)
    assert cuda_cic.LAUNCHES["deposit2"] == before + 1
    ra, rb = cuda_cic.deposit2_plain(p, va, vb, NG_MAG, periodic=periodic)
    da, db = cuda_cic.deposit2_plain(p.double(), va.double(), vb.double(),
                                     NG_MAG, periodic=periodic)
    for got, ref, ref64 in ((a, ra, da), (b, rb, db)):
        _rel_close(ref, got, 5e-5)
        _rel_close(ref64, got, 2e-5)


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
@pytest.mark.parametrize("ng", [600, 301, 128])
def test_boltzmann_dirichlet_kernel_matches_plain(cuda_device, ng):
    """The Newton kernel against its plain version (tests/test_pallas.py:
    315-342's cases and criteria): residual <= tol, counts within one
    (tol 1e-9 sits at the float32 floor), phi within 3e-5 of max|phi|;
    warm from the plain answer, equal counts. n0 comes as a device
    tensor."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", N_MAG)
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
