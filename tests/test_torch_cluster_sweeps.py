"""The cluster and pair modes of rows 17 and 14, on the CPU.

Row 17 (the slab's Picard pass, ``csrc/domain.cu``) sums its half-step
current on a bounded slab of ext_n nodes: no wrap, and in the shared
window a row's left node l = win_stride k + row - 1 may be -1 or
ext_n - 1, whose product outside [0, ext_n) the global mode drops. Its
cluster mode (``cic_common.cuh`` cluster_add_bounded) drops the same
products, and its pair mode stores a row at row l + 1 of an (ext_n + 1,
2) pair array and folds jh[i] = pair[i + 1][0] + pair[i][1], so the
dropped products land in cells the fold never reads. The CPU twins,
``cuda_cic.cluster_sum_plain`` and ``pair_sum_plain`` with
``bounded=True``, take C and the slice as arguments, so that at ext_n
1,000 with C = 4 (S = 250) rows astride the seams and at both ends reach
every branch.

Row 14 (the leapfrog deposit, ``csrc/explicit.cu``) sums on the periodic
grid as rows 1 and 2 do (``tests/test_torch_cluster_pass.py``).

Each twin's pass is held to its plain version (positions, velocities and
the clamp count bit-equal: the same operations; the sum to float32 or
float64 summation order, 2e-5 and 1e-12 of its largest node) and to
JAX's Pallas kernel in interpret mode at the limits of
``tests/test_torch_domain_kernels.py`` (row 17: 1e-6) and
``tests/test_torch_explicit.py`` (row 14: positions 1e-4 cells,
velocities 1e-4, rho 2e-5).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu.ops.pallas_cic import (leapfrog_gather_push_deposit_pallas,
                                      picard_iteration_ext_pallas)

from pypic_tpu_torch.ops import cuda_cic, cuda_domain

QM, W, DT, DX = -1.7e11, -3.2e-9, 1e-7, 0.05
EXT_N, C = 1000, 4
S = -(-EXT_N // C)  # 250
N = 16_384
# the slab's clamp bounds, wide enough that a midpoint's node reaches -1
# and ext_n - 1 (the shared window's l = floor(clamp(ph)) where no
# deposit leaves the frame)
LO, HI = -1.0, EXT_N - 0.5
# JAX's comparison runs on tests/test_torch_domain_kernels.py's slab (a
# middle rank of a 128-node grid: ext_n 45, clamp bounds 2 and 42; 4,099
# rows here), where its 1e-6 limits hold: JAX's window frame takes
# positions from 0 alone, and at 1,000 nodes and 16 rows a node float32
# summation order alone parts JAX's current from the port's by ~4e-6.
# C = 4 cuts it into slices of 12 nodes.
JAX_EXT_N, JAX_LO, JAX_HI, JAX_N = 45, 2.0, 42.0, 4_099
SUM_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
EXT_TOL = 1e-6  # tests/test_torch_domain_kernels.py
MODES = [("cluster", C), ("pair", 1)]


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


def _cells(ref, got, ng):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return np.minimum(d, ng - d).max()


# --- the bounded sums ------------------------------------------------------


def _exact_slab(left, t_left, t_right, ng):
    """The slab deposit as the global mode adds it: each term at its node,
    the terms at nodes outside [0, ng) dropped."""
    out = torch.zeros(ng, dtype=torch.float64)
    for node, term in ((left, t_left), (left + 1, t_right)):
        keep = (node >= 0) & (node < ng)
        out.index_add_(0, node[keep], term[keep])
    return out


@pytest.mark.parametrize("mode, cluster", MODES)
@pytest.mark.parametrize("left", [-2, -1, 0, 248, 249, 250, 499, 500, 749, 750, 998,
                                  999, 1000])
def test_bounded_sums_drop_what_the_global_mode_drops(left, mode, cluster):
    """One row at each seam and past each end: its two terms (integers,
    exact) land at the nodes it names, and a term at a node outside [0,
    ext_n) nowhere: no wrap."""
    got = cuda_cic.mode_sum_plain(mode, torch.tensor([left]), torch.tensor([left + 1]),
                                  torch.tensor([3.0], dtype=torch.float64),
                                  torch.tensor([5.0], dtype=torch.float64), EXT_N,
                                  cluster, bounded=True)
    want = torch.zeros(EXT_N, dtype=torch.float64)
    if 0 <= left < EXT_N:
        want[left] += 3.0
    if 0 <= left + 1 < EXT_N:
        want[left + 1] += 5.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode, cluster", MODES + [("cluster", 1), ("cluster", 16)])
def test_bounded_sum_of_many_rows_is_exact(mode, cluster):
    """20,000 rows with integer terms (exact sums), among them rows at l =
    -1 and ext_n - 1 and astride every seam: the sliced or paired sum
    equals the slab deposit bit for bit."""
    rng = np.random.default_rng(cluster)
    left = torch.from_numpy(rng.integers(-1, EXT_N, 20_000))
    left[:8] = torch.tensor([-1, EXT_N - 1, S - 1, S, 2 * S - 1, 2 * S, 3 * S - 1, 3 * S])
    t_left = torch.from_numpy(rng.integers(-8, 8, 20_000).astype(np.float64))
    t_right = torch.from_numpy(rng.integers(-8, 8, 20_000).astype(np.float64))
    got = cuda_cic.mode_sum_plain(mode, left, left + 1, t_left, t_right, EXT_N, cluster,
                                  bounded=True)
    assert torch.equal(got, _exact_slab(left, t_left, t_right, EXT_N))


def test_pair_rows_and_sums():
    """The pair array holds ng rows, ng + 1 on a bounded slab; the sum of a
    pass in the pair mode follows them (the pair array, then the ng-node
    sum); a mode other than cluster or pair raises."""
    assert cuda_cic.pair_rows(EXT_N) == EXT_N
    assert cuda_cic.pair_rows(EXT_N, bounded=True) == EXT_N + 1
    buf = cuda_cic._pass_sum("pair", EXT_N, torch.float32, "cpu", bounded=True)
    assert buf.shape == (3 * EXT_N + 2,) and not buf.any()
    assert cuda_cic._pass_sum("cluster", EXT_N, torch.float32, "cpu",
                              bounded=True).shape == (EXT_N,)
    with pytest.raises(ValueError, match="cluster' or 'pair"):
        cuda_cic.mode_sum_plain("global", torch.tensor([0]), torch.tensor([1]),
                                torch.ones(1), torch.ones(1), EXT_N)


# --- row 17 ----------------------------------------------------------------


def _slab_inputs(shared: bool, ext_n=EXT_N, lo=LO, hi=HI, n=N, seed=7):
    """n rows on an ext_n-node slab, the first ones at rest with their
    midpoints astride the seams of C slices and at both clamp bounds (with
    LO, HI: l = -1 and ext_n - 1 in the shared window), dead slots (w =
    0), positions past the clamp; a field. numpy float32."""
    rng = np.random.default_rng(seed)
    s = -(-ext_n // C)
    p0 = rng.uniform(lo - 2.0, hi + 2.0, n)
    at = [x - 1 + f for x in [r * s for r in range(1, C)] for f in (0.25, 0.75)]
    at += [lo + 0.5, lo + 0.75, hi - 0.25, hi - 0.1]
    p0[:len(at)] = at
    ps = p0 + rng.normal(size=n) * 0.3
    ps[:len(at)] = at
    v0 = rng.normal(size=n) * 1e5
    v0[:len(at)] = 0.0
    if shared:
        ps[len(at)::3] += 2.5  # iterates seeded off their frame: clamps counted
    field = rng.normal(size=ext_n) * 30.0
    w = np.full(n, W)
    w[rng.random(n) < 0.1] = 0.0
    w[:len(at)] = W
    return [a.astype(np.float32) for a in (field, ps, p0, v0, w)]


def _jax_slab(shared: bool):
    return _slab_inputs(shared, JAX_EXT_N, JAX_LO, JAX_HI, JAX_N)


def _tkw(lo=LO, hi=HI):
    return dict(qm=float(np.float32(QM)), dt=DT, dx=DX, lo=lo, hi=hi)


@functools.lru_cache(maxsize=None)
def _pallas_ext(shared: bool):
    arrs = _jax_slab(shared)
    out = picard_iteration_ext_pallas(*(jnp.asarray(a) for a in arrs), JAX_EXT_N,
                                      qm=jnp.float32(QM), dt=DT, dx=DX, lo=JAX_LO,
                                      hi=JAX_HI, emit_v=True, share_window=shared)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("mode, cluster", MODES)
@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
def test_slab_twin_matches_the_plain_pass(shared, mode, cluster):
    """ph, v1 and the clamp count bit-equal to ``picard_iteration_ext_plain``
    (the same operations); jh within float32 summation order; the inputs
    reach both ends of the slab."""
    arrs = [torch.from_numpy(a) for a in _slab_inputs(shared)]
    got = cuda_domain.picard_iteration_ext_cluster_plain(
        *arrs, emit_v=True, shared=shared, mode=mode, cluster=cluster, **_tkw())
    ref = cuda_domain.picard_iteration_ext_plain(*arrs, emit_v=True, shared=shared,
                                                 **_tkw())
    assert len(got) == len(ref) == 3 + shared
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert _rel(ref[2].numpy(), got[2].numpy()) <= SUM_TOL[torch.float32]
    if shared:
        assert int(got[3]) == int(ref[3]) > 0
    _, _, left, *_ = cuda_domain._ext_terms(*arrs, float(np.float32(QM)), DT, DX, LO, HI,
                                            shared)
    ends = {-1, EXT_N - 1} if shared else {0, EXT_N - 2}
    assert ends <= set(left.tolist())


@pytest.mark.parametrize("active", [0, 1])
@pytest.mark.parametrize("mode, cluster", MODES)
@pytest.mark.parametrize("shared", [False, True], ids=["separate", "shared"])
def test_slab_twin_matches_pallas(shared, mode, cluster, active):
    """The twin against JAX's picard_iteration_ext_pallas (interpret mode)
    on the same rows; with ``active`` 0 the pass leaves the iterate as it
    was and its current and count zero (the CPU wrapper's skip, which the
    kernels make by returning before their first barrier)."""
    arrs = _jax_slab(shared)
    kw = _tkw(JAX_LO, JAX_HI)
    ref = _pallas_ext(shared)
    if not active:
        buf, v1 = (torch.from_numpy(a.copy()) for a in arrs[1:3])
        t = [torch.from_numpy(a) for a in arrs]
        got = cuda_domain.picard_iteration_ext(*t[:1], buf, *t[2:], emit_v=True,
                                               shared=shared, out=(buf, v1),
                                               active=torch.zeros(1, dtype=torch.int32),
                                               **kw)
        assert torch.equal(got[0], torch.from_numpy(arrs[1])) and not got[2].any()
        assert not shared or int(got[3]) == 0
        return
    got = cuda_domain.picard_iteration_ext_cluster_plain(
        *(torch.from_numpy(a) for a in arrs), emit_v=True, shared=shared, mode=mode,
        cluster=cluster, **kw)
    for i in range(3):
        assert _rel(ref[i], got[i].numpy()) <= EXT_TOL, i
    if shared:
        assert int(ref[3]) == int(got[3])


# --- row 14 ----------------------------------------------------------------

NG = 1000


def _periodic_inputs(dtype, seed=11):
    """n = N rows whose new positions land astride the slices' seams and
    the wrap ng - 1 -> 0 (at rest in a zero field there), the others
    random; a field. numpy arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    npd = np.float32 if dtype == torch.float32 else np.float64
    p = rng.uniform(0, NG, N)
    at = [x - 1 + f for x in [r * S for r in range(1, C)] + [NG] for f in (0.25, 0.5, 0.75)]
    p[:len(at)] = at
    v = rng.normal(size=N) * 1e5
    v[:len(at)] = 0.0
    e = rng.normal(size=NG) * 1e3
    return [a.astype(npd) for a in (e, p, v)]


@pytest.mark.parametrize("dtype, mode, cluster", [
    (torch.float32, "cluster", C), (torch.float32, "pair", 1), (torch.float32, "cluster", 1),
    (torch.float64, "cluster", C), (torch.float64, "cluster", 2)],
    ids=["f32-cluster4", "f32-pair", "f32-cluster1", "f64-cluster4", "f64-cluster2"])
def test_leapfrog_twin_matches_the_plain_sweep(dtype, mode, cluster):
    """p1 and v1 bit-equal to ``leapfrog_gather_push_deposit_plain``; rho
    within the dtype's summation order."""
    arrs = [torch.from_numpy(a) for a in _periodic_inputs(dtype)]
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    got = cuda_cic.leapfrog_gather_push_deposit_cluster_plain(*arrs, mode=mode,
                                                              cluster=cluster, **kw)
    ref = cuda_cic.leapfrog_gather_push_deposit_plain(*arrs, **kw)
    assert all(t.dtype == dtype for t in got)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert _rel(ref[2].numpy(), got[2].numpy()) <= SUM_TOL[dtype]


@pytest.mark.parametrize("mode, cluster", MODES)
def test_leapfrog_twin_matches_pallas(mode, cluster):
    """The twin against JAX's leapfrog_gather_push_deposit_pallas
    (interpret mode) at tests/test_torch_explicit.py's limits."""
    e, p, v = _periodic_inputs(torch.float32)
    ref = leapfrog_gather_push_deposit_pallas(jnp.asarray(e), jnp.asarray(p), jnp.asarray(v),
                                              qm=jnp.float32(QM), w=jnp.float32(W), dt=DT,
                                              dx=DX)
    got = cuda_cic.leapfrog_gather_push_deposit_cluster_plain(
        *(torch.from_numpy(a) for a in (e, p, v)), qm=QM, w=W, dt=DT, dx=DX, mode=mode,
        cluster=cluster)
    assert _cells(np.asarray(ref[0]), got[0].numpy(), NG) < 1e-4
    assert _rel(np.asarray(ref[1]), got[1].numpy()) <= 1e-4
    assert _rel(np.asarray(ref[2]), got[2].numpy()) <= 2e-5
