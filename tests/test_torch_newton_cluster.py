"""The Newton solves' large path in its cluster mode (csrc/newton.cu
newton_cluster_kernel; ops/cuda_newton.py large_shape, _cluster_solve)
against pypic_tpu and a dense solve, on the CPU.

In the mode 'cluster' the rows are spread over C CTAs of a thread-block
cluster: each CTA reduces its blocks to their end rows, solves its inner
end rows for the right-hand sides and two spike columns, and the CTAs'
first and last rows form a tridiagonal system of 2 C rows that every CTA
solves alike. The plain version (``_cluster_solve``) follows that order;
it is held here to a float64 dense solve, to the Pallas kernels in
interpret mode and through the engine to JAX's step. The kernels are held
to the plain versions on the card (tests/test_torch_cuda.py,
tests/test_torch_float64_cuda.py, chip_smoke.py phase 24). Inputs come
from numpy with a seed; each tolerance is stated beside its test.
"""

import dataclasses as dc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu import presets as jpresets
from pypic_tpu import sources as jsources
from pypic_tpu.engines import magnetized as jmag
from pypic_tpu.ops.pallas_newton import boltzmann_dirichlet_pallas, boltzmann_dn_pallas

from pypic_tpu_torch import interop
from pypic_tpu_torch.constants import E_CHARGE
from pypic_tpu_torch.engines import magnetized
from pypic_tpu_torch.grid import GridSpec
from pypic_tpu_torch.ops import _build, cuda_cic, cuda_newton

TE, DX = 11600.0 * 10.0, 2e-5
N0_DD, N0_DN = np.float32(1e17), np.float32(0.9e17)


def _force_cluster(monkeypatch, cluster: int) -> None:
    """The Newton solves' large path in the cluster mode at ``cluster``
    CTAs, whatever NEWTON_RULE takes (large_shape patched)."""
    real = cuda_newton.large_shape
    monkeypatch.setattr(cuda_newton, "large_shape",
                        lambda rows, item=4, mode=None, c=None, threads=None, dn=True:
                        real(rows, item, "cluster", cluster, threads, dn))


def _density(ng: int, seed: int) -> np.ndarray:
    """tests/test_pallas.py:315-389's number densities: 1e17 m^-3 with 30%
    noise (tests/test_torch_newton_large.py's load)."""
    rng = np.random.default_rng(seed)
    return (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15).astype(np.float32)


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("rows", [1025, 2048, 4100, 8000, 16_384, 65_536, 262_144])
def test_rule_takes_its_mode_from_the_rows_and_the_dtype(rows, item):
    """large_mode and large_shape are functions of the rows and the element
    bytes alone: the last NEWTON_RULE entry at or below the rows, its
    CTAs a cluster; the same answer every call, for both kernels."""
    mode = "single"
    cluster = None
    for first, rule, size in cuda_newton.NEWTON_RULE[item]:
        if rows >= first:
            mode, cluster = rule, size
    assert cuda_newton.large_mode(rows, item) == mode in cuda_newton.LARGE_MODES
    for dn in (False, True):
        shape = cuda_newton.large_shape(rows, item, dn=dn)
        assert shape == cuda_newton.large_shape(rows, item, dn=dn)
        assert shape.mode == mode
        assert shape.cluster == (cluster if mode == "cluster" else 1)
        assert cuda_newton.solve_rows(rows, item) == shape.rows >= rows


def _row_counts():
    """1,025 to LARGE_MAX_ROWS: every count to 2,100, then a geometric
    ladder with its neighbours."""
    out = set(range(1025, 2101))
    r = 2101.0
    while r < cuda_newton.LARGE_MAX_ROWS:
        out.update({int(r) - 1, int(r), int(r) + 1})
        r *= 1.07
    out.update({cuda_newton.LARGE_MAX_ROWS - 1, cuda_newton.LARGE_MAX_ROWS})
    return sorted(out)


@pytest.mark.parametrize("item", [4, 8])
def test_every_row_count_gets_a_cluster_shape(item):
    """Every row count from 1,025 to LARGE_MAX_ROWS gets a cluster shape at
    every C the kernel takes and at the rule's: C a power of two in [2,
    16], threads a multiple of 32 in [32, CLUSTER_THREADS], k >= 2, the
    rows inside C T k and the last block row holding some (C T (k - 1) <
    rows), the shared bytes (counting the kernel's static bytes, Fault 5's
    lesson) within SMEM_LIMIT, and the rows' scratch in shared memory
    exactly where it fits."""
    limit = cuda_cic.SMEM_LIMIT - cuda_newton.CLUSTER_STATIC_BYTES
    for rows in _row_counts():
        for c in (None, 2, 4, 8, 16):
            dn = c in (None, 4, 16)
            s = cuda_newton.large_shape(rows, item, "cluster", c, dn=dn)
            assert 2 <= s.cluster <= cuda_newton.CLUSTER_MAX == 16
            assert s.cluster & (s.cluster - 1) == 0
            assert s.threads % 32 == 0 and 32 <= s.threads <= cuda_newton.CLUSTER_THREADS
            assert s.k >= 2 and s.cluster * s.threads * (s.k - 1) < rows <= s.rows
            assert s.smem <= limit
            full = cuda_newton.cluster_smem(dn, item, s.cluster, s.threads, s.k, True)
            assert s.shared == (full <= limit)
            assert s.smem == cuda_newton.cluster_smem(dn, item, s.cluster, s.threads, s.k,
                                                      s.shared)


def test_cluster_smem_counts_each_region():
    """cluster_smem mirrors csrc/newton.cu cluster_layout, region by region
    (each 16-B aligned), for the D-N kernel in float32 at C = 16, T = 128,
    k = 8: partials 256, warp partials 256, rows pushed 2 x 16 x 2 x 5 x
    4 = 1,280, ingredients 96, minima 64, block minimum 128, PCR rows 2 x
    256 x 16 = 8,192 and planes 2 x 3 x 256 x 4 = 6,144, edge phi 1,024,
    the rows' scratch 6 x 1,024 x 4 = 24,576; the D-D kernel lacks the
    ingredients, a plane and a scratch row; doubles take twice the
    elements. The cluster entry points are launchers of the library."""
    want = 256 + 256 + 1280 + 96 + 64 + 128 + 8192 + 6144 + 1024 + 24576
    assert cuda_newton.cluster_smem(True, 4, 16, 128, 8, True) == want == 42_016
    assert cuda_newton.cluster_smem(True, 4, 16, 128, 8, False) == want - 24_576
    dd = 256 + 256 + 16 * 2 * 2 * 4 * 4 + 64 + 128 + 8192 + 2 * 2 * 256 * 4 + 1024
    assert cuda_newton.cluster_smem(False, 4, 16, 128, 8, False) == dd
    assert cuda_newton.cluster_smem(True, 8, 16, 128, 8, False) == (
        512 + 2 * 1280 + 2 * 96 + 2 * 64 + 2 * 128 + 2 * 8192 + 2 * 6144 + 2 * 1024)
    for name in ("boltzmann_dirichlet", "boltzmann_dn"):
        for suffix in ("", "_f64"):
            assert f"pypic_{name}_cluster{suffix}" in _build._SIGNATURES
    for name in ("pypic_newton_clusters", "pypic_newton_cluster_smem"):
        assert name in _build._SIGNATURES


def test_forced_shapes_refuse_what_the_kernel_refuses():
    """large_shape raises on a mode it does not know, on C outside the
    powers of two in [2, 16] and on threads the kernel refuses; the mode
    'single' is large_split's one CTA, its scratch in device memory, and
    at most SMALL_MAX_ROWS rows is no large path."""
    with pytest.raises(ValueError, match="mode"):
        cuda_newton.large_shape(4096, 4, "pair")
    for c in (1, 3, 32):
        with pytest.raises(ValueError, match="power of two"):
            cuda_newton.large_shape(4096, 4, "cluster", c)
    for t in (16, 100, 1024):
        with pytest.raises(ValueError, match="threads"):
            cuda_newton.large_shape(4096, 4, "cluster", 4, t)
    with pytest.raises(ValueError, match="more than 1024"):
        cuda_newton.large_shape(1024, 4, "cluster")
    s = cuda_newton.large_shape(4096, 8, "single")
    assert (s.mode, s.cluster, (s.k, s.threads), s.shared) == (
        "single", 1, cuda_newton.large_split(4096, 8), False)


def _system(rows: int, r: int, rng, dtype):
    """A (rows,) tridiagonal system with r right-hand sides: 4 + |N(0, 1)|
    on the diagonal, N(0, 1) couplings (diagonally dominant, as the Newton
    Jacobians are), the first row's a and the last row's c zero."""
    d = 4.0 + np.abs(rng.standard_normal(rows))
    a, c = rng.standard_normal(rows), rng.standard_normal(rows)
    a[0] = c[-1] = 0.0
    f = rng.standard_normal((r, rows))
    dense = np.diag(d) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    ref = np.linalg.solve(dense, f.T).T
    return [torch.from_numpy(x.astype(dtype)) for x in (a, d, c, f)], ref


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("ng", [2049, 2500, 3073, 4100])
def test_plain_cluster_solve_matches_dense_float64(ng, cluster):
    """_cluster_solve at forced C = 2 and 4, ng rows and identity rows past
    them up to large_shape's C T k (ragged last blocks and a part-empty
    last CTA), one and two right-hand sides, against a float64 dense
    solve of the same float32 system: within 1e-5 of the largest value
    (the kernels' tolerance against their plain versions, chip_smoke.py
    TOL_CHAIN)."""
    shape = cuda_newton.large_shape(ng, 4, "cluster", cluster)
    assert shape.cluster == cluster and shape.rows > ng
    rng = np.random.default_rng(ng + cluster)
    (a, d, c, f), ref = _system(ng, 2, rng, np.float32)
    pad = shape.rows - ng
    z, o = torch.zeros(pad), torch.ones(pad)
    args = (torch.cat([a, z]), torch.cat([d, o]), torch.cat([c, z]))
    for rhs, want in ((torch.cat([f, torch.zeros(2, pad)], 1), ref),
                      (torch.cat([f[0], z]), ref[0])):
        got = cuda_newton._cluster_solve(*args, rhs, shape.cluster, shape.threads, shape.k)
        assert got.shape == rhs.shape
        scale = np.abs(want).max()
        assert np.abs(got[..., :ng].double().numpy() - want).max() <= 1e-5 * scale
        assert float(got[..., ng:].abs().max()) == 0.0


@pytest.mark.parametrize("ng", [1100, 3000])
def test_plain_cluster_solve_float64_matches_dense(ng):
    """The float64 plain cluster solve at C = 4 against a float64 dense
    solve of the same system: within 1e-12 of the largest value (float64
    rounding of a tridiagonal solve)."""
    shape = cuda_newton.large_shape(ng, 8, "cluster", 4)
    (a, d, c, f), ref = _system(shape.rows, 2, np.random.default_rng(ng), np.float64)
    got = cuda_newton._cluster_solve(a, d, c, f, shape.cluster, shape.threads, shape.k)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("ng", [2049, 4100])
def test_boltzmann_dirichlet_cluster_plain_matches_pallas(ng, cluster, monkeypatch):
    """The D-D plain version in the cluster mode (forced C = 2 and 4)
    against boltzmann_dirichlet_pallas in interpret mode, cold and warm:
    phi at rtol 1e-3 / atol 1e-8 (tests/test_torch_newton_large.py's
    limits), the Newton counts within one (tol 1e-9 sits at the float32
    floor); the wrapper on CPU tensors is the plain version and launches
    nothing."""
    _force_cluster(monkeypatch, cluster)
    rho = E_CHARGE * _density(ng, 11 + ng)
    kw = dict(tol=1e-9)
    ref = boltzmann_dirichlet_pallas(jnp.asarray(rho), N0_DD, TE, DX, tol=1e-9)
    before = dict(cuda_cic.LAUNCHES)
    got = cuda_newton.boltzmann_dirichlet(torch.from_numpy(rho), float(N0_DD), TE, DX, **kw)
    assert cuda_cic.LAUNCHES == before
    assert got.phi.shape == (ng,) and float(got.residual) <= 1e-9
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(ref.phi), rtol=1e-3, atol=1e-8)
    ref_w = boltzmann_dirichlet_pallas(jnp.asarray(rho), N0_DD, TE, DX, tol=1e-9,
                                       phi0=ref.phi)
    got_w = cuda_newton.boltzmann_dirichlet(torch.from_numpy(rho), float(N0_DD), TE, DX,
                                            phi0=torch.from_numpy(np.array(ref.phi)), **kw)
    assert abs(int(got_w.iterations) - int(ref_w.iterations)) <= 1
    np.testing.assert_allclose(got_w.phi.numpy(), np.asarray(ref_w.phi), rtol=1e-3,
                               atol=1e-8)


# D-N placements of the Neumann row ng - 1 (and of row ng - 3, whose owner
# pushes its recovery to every CTA) on a shape the kernel takes: C = 4 CTAs
# of 128 threads, k = 4 (512 rows a CTA, 2,048 in all)
DN_SHAPE = cuda_newton.LargeShape("cluster", 4, 128, 4,
                                  cuda_newton.cluster_smem(True, 4, 4, 128, 4, True), True)
DN_PLACES = {
    1537: "ng - 1 on CTA 3's first row; ng - 3 on CTA 2's last thread",
    1536: "ng - 1 on CTA 2's last row",
    1800: "ng - 1 inside CTA 3",
    1027: "ng - 3 on CTA 2's first row (thread 0, its block's row 0)",
}


@pytest.mark.parametrize("ng", sorted(DN_PLACES))
def test_boltzmann_dn_cluster_plain_matches_pallas(ng, monkeypatch):
    """The D-N plain version in the cluster mode at DN_SHAPE, with the
    Neumann row ng - 1 on a CTA's first row, on its last row and inside a
    CTA (DN_PLACES), against boltzmann_dn_pallas in interpret mode, cold
    and warm: phi at rtol 1e-3 / atol 1e-8, the counts within one."""
    monkeypatch.setattr(cuda_newton, "large_shape", lambda *a, **k: DN_SHAPE)
    npad = DN_SHAPE.threads * DN_SHAPE.k
    if ng in (1537, 1536):
        assert (ng - 1) % npad == (0 if ng == 1537 else npad - 1)
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


@pytest.mark.parametrize("kind", ["dd", "dn"])
def test_cluster_and_single_modes_agree_in_float64(kind, monkeypatch):
    """The float64 plain loops in the cluster mode (C = 4) and the mode
    'single' on the same load, 8 iterations at tol 0: phi within 1e-12
    of its largest (the two partition orders' float64 rounding)."""
    ng = 3000
    dens = _density(ng, 17).astype(np.float64)
    kw = dict(tol=0.0, maxiter=8)
    if kind == "dd":
        rho = torch.from_numpy(E_CHARGE * dens)
        run = functools.partial(cuda_newton.boltzmann_dirichlet, rho, 1e17, TE, DX, **kw)
    else:
        run = functools.partial(cuda_newton.boltzmann_dn, torch.from_numpy(dens), 0.9e17,
                                TE, DX, torch.zeros(ng, dtype=torch.float64), **kw)
    one = run(mode="single")
    _force_cluster(monkeypatch, 4)
    many = run()
    assert one.phi.dtype == many.phi.dtype == torch.float64
    assert int(one.iterations) == int(many.iterations) == 8
    assert float((one.phi - many.phi).abs().max()) <= 1e-12 * float(one.phi.abs().max())


NG_STEP = 2048


# the step's Newton tolerance: the config's 1e-9 sits at the float32 floor
# of sum(dphi^2) over 2,048 rows (the residual hovers at ~7e-10 to 1e-9),
# where the iteration count turns on the last bits of the sums: at that
# tol the port read 5-8 iterations (the mode 'single' and C = 2-16, and
# with the process's thread count) and JAX 5 or 6 on one state. At 1e-7
# the count is set by the convergence and the counts can be compared
NEWTON_TOL_STEP = 1e-7


@pytest.mark.parametrize("cluster", [2, 16])
def test_magnetized_step_on_the_cluster_mode_matches_jax(cluster, monkeypatch):
    """One magnetized step at ng = 2,048 with newton_backend 'pallas' and
    newton_tol NEWTON_TOL_STEP from JAX's state after one step, the port's
    Newton forced into the cluster mode at C = 2 and 16 (large_shape),
    against boltzmann_dirichlet_pallas in interpret mode, the JAX source
    draws replayed; the limits of tests/test_torch_newton_large.py's step
    (rho rtol 1e-4, phi rtol 1e-3 / atol 1e-8, active positions rtol 2e-5
    / atol 1e-5, velocities rtol 2e-4 / atol 1, equal counts, Newton
    counts within one)."""
    _force_cluster(monkeypatch, cluster)
    jpre = jpresets.pic_iead(n_per_species=500, ng=NG_STEP)
    js1, _ = jax.jit(jmag.make_step(jpre.config))(jpre.state)
    jcfg = dc.replace(jpre.config, newton_backend="pallas", newton_tol=NEWTON_TOL_STEP)
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
    ts, tm = magnetized.make_step(tcfg, source_draws=lambda s, k: draws)(
        interop.magnetized_state_from_numpy(d, "cpu"))
    assert cuda_cic.LAUNCHES == before
    assert cuda_newton.large_shape(NG_STEP).cluster == cluster
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


def test_large_split_cuts_apply_to_the_newton_source():
    """tools/resident_split.py --kernel newton_dd_large|newton_dn_large cuts
    the one-CTA large kernels by text edits of csrc/newton.cu: each anchor
    stands in the source as many times as its edit says (the loop test
    once in each large kernel), the cluster kernel is left as it is, and
    every launcher stays."""
    from pypic_tpu_torch.tools import resident_split

    src = (_build.CSRC_DIR / "newton.cu").read_text()
    cut = resident_split._edited(src, resident_split._NEWTON_LARGE_EDITS)
    assert cut.count("(CUT != 0 || residual > s.tol)") == 2
    assert cut.count("CUT_ENDS(") == 3  # the macro and the two kernels
    start = src.index("__global__ void __launch_bounds__(kClusterThreads)")
    body = src[start:src.index("\n}\n", start)]
    assert body in cut
    for name in ("boltzmann_dirichlet", "boltzmann_dn"):
        for kind in ("large", "cluster"):
            assert f"int pypic_{name}_{kind}(" in cut
    assert set(resident_split.NEWTON_LARGE_CUTS.values()) == set(range(4))
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited(src.replace("pcr_solve_pair<2>(x0, x1, buf, 2 * T_);", "x"),
                               resident_split._NEWTON_LARGE_EDITS)


@pytest.mark.parametrize("mode", ["single", "cluster"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dn", [False, True])
def test_split_caller_passes_the_entry_points_arguments(dn, dtype, mode):
    """resident_split.newton_large_caller, which launches the split's cuts
    and chip_smoke.py phase 24's latency floor (cut (c), NEWTON_FLOOR_CUT),
    calls the entry point of the shape's mode and dtype with as many
    arguments as _build._SIGNATURES gives it: the shape, a null warm start
    for D-D, tol 0, the iterations asked for and the wrappers' scalars
    (newton_scalars, _coef, _EXP_CLAMP) in the wrappers' places."""
    from pypic_tpu_torch.constants import EPSILON_0
    from pypic_tpu_torch.tools import resident_split

    seen = {}

    class Lib:
        def __getattr__(self, name):
            return lambda *args: seen.setdefault(name, args) and 0

    rows, item = 2049, torch.finfo(dtype).bits // 8
    shape = cuda_newton.large_shape(rows, item, mode, 4 if mode == "cluster" else None, dn=dn)
    call = resident_split.newton_large_caller(dn, rows, dtype, torch.device("cpu"), shape.rows)
    call(Lib(), shape, 8)
    what = "boltzmann_dn" if dn else "boltzmann_dirichlet"
    name = (f"pypic_{what}_{'large' if mode == 'single' else 'cluster'}"
            + ("_f64" if dtype == torch.float64 else ""))
    assert list(seen) == [name]
    args = seen[name]
    assert len(args) == len(_build._SIGNATURES[name][0])
    assert (args[2] is None) == (not dn) and all(a is not None for a in args[3:7])
    shape_args = ((rows, shape.k, shape.threads) if mode == "single" else
                  (rows, shape.k, shape.threads, shape.cluster, int(shape.shared)))
    assert args[7:7 + len(shape_args)] == shape_args
    c1, dx2, _, step_max = cuda_newton.newton_scalars(11600.0 * 10.0, 2e-5, 0.0, dtype)
    head = ((cuda_newton._coef(dtype),) if dn else
            (cuda_newton._coef(dtype), float(cuda_newton.real(dtype)(EPSILON_0))))
    assert args[7 + len(shape_args):] == head + (c1, dx2, 0.0, 8, step_max,
                                                 cuda_newton._EXP_CLAMP, None)
    assert resident_split.NEWTON_LARGE_CUTS[resident_split.NEWTON_FLOOR_CUT] == 2
