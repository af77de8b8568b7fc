"""The cluster mode's sum of rows 1 and 2 (csrc/cic.cu kCluster), on the CPU.

The kernel cuts the (ng,) half-step current into C slices of S =
ceil(ng / C) nodes, one a CTA of a thread-block cluster, and adds each
row's two products into the slice that owns their node: owner l // S at
offset l % S for the left node, the next offset (the next owner's first
past S - 1, node 0's past ng - 1) for the right. Its CPU twin,
``cuda_cic.cluster_sum_plain``, takes C and S as arguments, so that at ng
1,000 with C = 4 (S = 250) rows astride the seams r S - 1 -> r S and the
wrap ng - 1 -> 0 reach every branch of that arithmetic.

The twin's pass (``picard_iteration_cluster_plain``) is held against the
plain versions of both windows (ph, v1 and the clamp count bit-equal: the
same operations; jh to float32 or float64 summation order, 2e-5 and 1e-12
of its largest node) and against JAX's ``picard_iteration_pallas`` in
interpret mode. Its Pallas kernels gather through float32 window
contractions and accumulate the current in float32 in both dtypes, so
the float32 limits hold in both: positions 1e-4 cells, velocities 1e-4 of
their largest value, jh 2e-5 of its largest node (float32 summation
order), as tests/test_torch_kernels.py holds them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu.ops.pallas_cic import picard_iteration_pallas

from pypic_tpu_torch.ops import cuda_cic

QM, W, DT, DX = -1.7e11, -3.2e-9, 1e-7, 0.05
NG, C = 1000, 4
S = -(-NG // C)  # 250
N = 16_384  # about 33 rows a node
# float32 or float64 summation order of a node's sum, of its largest node
SUM_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
# JAX's pass gathers through float32 window contractions in both dtypes
JAX_TOL = dict(p=1e-4, v=1e-4)


def _seam_inputs(dtype, seed=5):
    """n = N random rows, the first ones at rest astride the slices'
    seams r S - 1 -> r S and the wrap ng - 1 -> 0 (their midpoints land
    there), and a field; numpy arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    npd = np.float32 if dtype == torch.float32 else np.float64
    p0 = rng.uniform(0, NG, N)
    at = [x - 1 + f for x in [r * S for r in range(1, C)] + [NG] for f in (0.25, 0.5, 0.75)]
    p0[:len(at)] = at
    ps = p0 + rng.normal(size=N) * 0.05
    ps = np.mod(ps, NG)
    v0 = rng.normal(size=N) * 1e5
    v0[:len(at)] = 0.0
    e = rng.normal(size=NG) * 1e3
    return [a.astype(npd) for a in (e, ps, p0, v0)]


def _rel(ref, got):
    ref, got = torch.as_tensor(ref).double(), torch.as_tensor(got).double()
    return float((ref - got).abs().max() / ref.abs().max())


def _cells(ref, got, ng):
    d = (torch.as_tensor(ref).double() - torch.as_tensor(got).double()).abs()
    return float(torch.minimum(d, ng - d).max())


@pytest.mark.parametrize("left, right", [(0, 1), (248, 249), (249, 250), (250, 251),
                                         (499, 500), (749, 750), (998, 999), (999, 0)])
def test_owner_and_offset_of_each_seam(left, right):
    """One row at each seam: its two terms land at the nodes it names,
    exactly (integer terms), whatever slice owns them."""
    got = cuda_cic.cluster_sum_plain(
        torch.tensor([left]), torch.tensor([right]), torch.tensor([3.0], dtype=torch.float64),
        torch.tensor([5.0], dtype=torch.float64), NG, C, S)
    want = torch.zeros(NG, dtype=torch.float64)
    want[left] += 3.0
    want[right] += 5.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("cluster, slice_", [(1, 1000), (2, 500), (4, 250), (8, 125),
                                             (16, 63), (3, 334)])
def test_sliced_sum_equals_the_plain_deposit(cluster, slice_):
    """Every row's terms (small integers, so every sum is exact) summed
    through ``cluster`` slices of ``slice_`` nodes equal ``deposit_plain``
    bit for bit, the last slice holding fewer nodes than the others."""
    rng = np.random.default_rng(cluster)
    p = torch.from_numpy(rng.uniform(0, NG, 20_000))
    p[:4] = torch.tensor([0.0, NG - 0.5, 249.5, 250.0], dtype=torch.float64)
    vals = torch.from_numpy(rng.integers(-8, 8, 20_000).astype(np.float64))
    left = torch.floor(p).long()
    right = torch.where(left + 1 == NG, 0, left + 1)
    wr = torch.full_like(p, 0.25)  # dyadic weights: exact products
    got = cuda_cic.cluster_sum_plain(left, right, vals * 0.75, vals * wr, NG, cluster, slice_)
    want = torch.zeros(NG, dtype=torch.float64)
    want.index_add_(0, left, vals * 0.75)
    want.index_add_(0, right, vals * wr)
    assert torch.equal(got, want)


def test_slices_that_do_not_hold_the_grid_raise():
    with pytest.raises(ValueError, match="do not hold"):
        cuda_cic.cluster_sum_plain(torch.tensor([0]), torch.tensor([1]),
                                   torch.ones(1), torch.ones(1), NG, 4, 249)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("share_window", [False, True], ids=["separate", "shared"])
def test_cluster_twin_matches_the_plain_pass(share_window, dtype):
    """ph, v1 and the clamp count bit-equal to the plain version's (the
    same operations), jh within the dtype's summation order."""
    e, ps, p0, v0 = (torch.from_numpy(a) for a in _seam_inputs(dtype))
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    got = cuda_cic.picard_iteration_cluster_plain(e, ps, p0, v0, NG, cluster=C, slice_=S,
                                                  share_window=share_window, **kw)
    if share_window:
        ref = cuda_cic.picard_iteration_shared_plain(e, ps, p0, v0, NG, emit_v=True, **kw)
        assert int(got[3]) == int(ref[3])
    else:
        ref = cuda_cic.picard_iteration_plain(e, ps, p0, v0, NG, emit_v=True, **kw)
    assert all(t.dtype == dtype for t in got[:3])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert _rel(ref[2], got[2]) <= SUM_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("share_window", [False, True], ids=["separate", "shared"])
def test_cluster_twin_matches_pallas(share_window, dtype):
    """The twin's pass against JAX's picard_iteration_pallas (interpret
    mode) on the same seam rows."""
    arrs = _seam_inputs(dtype)
    kw = dict(qm=QM, w=W, dt=DT, dx=DX)
    ref = picard_iteration_pallas(*(jnp.asarray(a) for a in arrs), NG, emit_v=True,
                                  share_window=share_window, **kw)
    got = cuda_cic.picard_iteration_cluster_plain(
        *(torch.from_numpy(a) for a in arrs), NG, cluster=C, slice_=S,
        share_window=share_window, **kw)
    assert _cells(np.asarray(ref[0]), got[0], NG) <= JAX_TOL["p"]
    assert _rel(np.asarray(ref[1]), got[1]) <= JAX_TOL["v"]
    assert _rel(np.asarray(ref[2]), got[2]) <= SUM_TOL[torch.float32]
    if share_window:
        assert int(ref[3]) == int(got[3])
