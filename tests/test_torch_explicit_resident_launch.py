"""The resident explicit kernel's launch shape and sums, on the CPU.

``cuda_cic.explicit_resident_shape(n, ng)`` fixes the launch of
``csrc/explicit.cu``'s resident kernel: one cluster of 8 CTAs, CTA r owning
a contiguous range of rows and each of its 512 threads at most 8 of them
in registers. The partition sets the order of the kernel's sums, so it
must depend on (n, ng) alone, cover every row once, fit the card's shared
memory for every ng the kernel takes, and raise where the kernel cannot
run. The kernel's rho is the rank-order sum of the CTAs' partial
deposits, and its field a pointwise function of one prefix sum; both are
replayed here in PyTorch and numpy against the plain versions.
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch.ops import cuda_cic
from pypic_tpu_torch.tools import two_stream

RAGGED_NS = (4097, 10_000, 32_767, 32_768)


@pytest.mark.parametrize("ng", [2, 200, 1024])
@pytest.mark.parametrize("n", RAGGED_NS)
def test_launch_shape(n, ng):
    shape = cuda_cic.explicit_resident_shape(n, ng)
    assert shape.cluster == cuda_cic.RESIDENT_EXPLICIT_CLUSTER == 8
    assert shape.threads == cuda_cic.RESIDENT_EXPLICIT_THREADS == 512
    assert shape.per_cta == -(-n // 8)
    assert shape.per_thread == -(-shape.per_cta // shape.threads)
    assert shape.per_thread * shape.threads <= cuda_cic.RESIDENT_EXPLICIT_ROWS
    assert shape == cuda_cic.explicit_resident_shape(n, ng)
    # the configs[0] row's 1,250 particles a CTA, 3 a thread; the largest
    # n's 4,096, 8 a thread
    if n == 10_000:
        assert (shape.per_cta, shape.per_thread) == (1250, 3)
    if n == 32_768:
        assert (shape.per_cta, shape.per_thread) == (4096, 8)


def test_shared_memory_fits_every_ng():
    """Every ng from 2 to 1,024: three steps of the ke, jb partials rank 0
    receives (6 float64 a warp of the cluster's 8 x 16), three float64 a
    warp of the field solve's sums, two mbarriers, the deposit's 32
    columns a node, the received totals of two step parities (16 a node)
    and the field, inside the 232,448 B a block may use (207,248 B at
    ng = 1,024). The card test test_explicit_resident_smem_is_the_kernels
    holds this to the kernel's own count."""
    for ng in range(2, cuda_cic.RESIDENT_MAX_NG + 1):
        shape = cuda_cic.explicit_resident_shape(32_768, ng)
        assert shape.smem == 8 * 51 * 16 + 16 + 4 * (32 + 17) * ng
        assert shape.smem <= cuda_cic.SMEM_LIMIT
    assert cuda_cic.explicit_resident_shape(32_768, 1024).smem == 207_248


@pytest.mark.parametrize("n", (1, 17, 1024, *RAGGED_NS))
def test_partition_covers_every_row_once(n):
    rows = cuda_cic.explicit_resident_rows(n, 200)
    shape = cuda_cic.explicit_resident_shape(n, 200)
    assert rows.shape == (8, shape.threads,
                          cuda_cic.RESIDENT_EXPLICIT_ROWS // shape.threads)
    held = rows[rows >= 0]
    assert held.size == n
    np.testing.assert_array_equal(np.sort(held), np.arange(n))


@pytest.mark.parametrize("n", RAGGED_NS)
def test_partition_gives_each_cta_a_contiguous_range(n):
    """CTA r holds rows [r per_cta, (r + 1) per_cta) clipped to n; slot j
    of thread t holds row r per_cta + j threads + t (coalesced loads)."""
    shape = cuda_cic.explicit_resident_shape(n, 200)
    rows = cuda_cic.explicit_resident_rows(n, 200)
    for r in range(shape.cluster):
        lo, hi = r * shape.per_cta, min((r + 1) * shape.per_cta, n)
        got = rows[r][rows[r] >= 0]
        np.testing.assert_array_equal(np.sort(got), np.arange(lo, max(lo, hi)))
        j_of = (rows[r] - lo) // shape.threads
        assert np.all((j_of == np.arange(rows.shape[2])[None, :])[rows[r] >= 0])
    assert np.all(rows[:, :, shape.per_thread:] == -1)


@pytest.mark.parametrize("n,ng,match", [
    (32_769, 200, "n <= 32768"),
    (100_000, 200, "n <= 32768"),
    (10_000, 1025, "ng <= 1024"),
    (10_000, 2048, "ng <= 1024"),
])
def test_shape_refuses_past_the_limits(n, ng, match):
    with pytest.raises(ValueError, match=match):
        cuda_cic.explicit_resident_shape(n, ng)


def test_wrapper_refuses_past_n_limit_on_either_device():
    """The wrapper's n limit holds for CPU tensors too, with the shape's
    message; ng is limited on the card only (the plain version runs any
    ng)."""
    ng = 64
    big = torch.zeros(cuda_cic.RESIDENT_MAX_N + 1)
    e = torch.zeros(ng)
    with pytest.raises(ValueError, match="n <= 32768"):
        cuda_cic.explicit_cycle_resident(e, big, big, ng, 1, qm=-1.7e11,
                                         w=-3.2e-9, ke_c=1.0, jb_c=1.0,
                                         dt=1e-7, dx=0.05, fe_c=1.0)
    ng = 1100
    f = torch.linspace(-1e3, 1e3, ng)
    p = torch.linspace(0.0, ng - 1e-3, 500)
    out = cuda_cic.explicit_cycle_resident(f, p, torch.zeros(500), ng, 2,
                                           qm=-1.7e11, w=-3.2e-9, ke_c=1.0,
                                           jb_c=1.0, dt=1e-7, dx=0.05, fe_c=1.0)
    assert out[3].shape == (ng,)


@pytest.mark.parametrize("n", RAGGED_NS)
def test_rank_order_sum_of_cta_deposits_is_the_deposit(n):
    """rho as the kernel forms it: each CTA deposits the rows the map gives
    it, and the 8 partial histograms are added in rank order in float32.
    Against the plain deposit of all n (index_add_, another order): within
    float32 summation-order error, 2e-5 of the largest node (the deposit
    tolerance of the CPU kernel tests; a node sums ~2n/ng terms of one
    weight); both against a float64 deposit at the same 2e-5."""
    ng = 200
    cfg, _, st = two_stream.state(n, "cpu")
    w = float(np.float32(st.q * cfg.p2c / cfg.grid.dx))
    rows = cuda_cic.explicit_resident_rows(n, ng)
    wv = torch.full((n,), w, dtype=torch.float32)
    rho = torch.zeros(ng, dtype=torch.float32)
    for r in range(rows.shape[0]):
        mine = torch.from_numpy(np.sort(rows[r][rows[r] >= 0]))
        part = cuda_cic.deposit_plain(st.p[mine], wv[mine], ng, periodic=True)
        rho = rho + part
    plain = cuda_cic.deposit_plain(st.p, wv, ng, periodic=True)
    exact = cuda_cic.deposit_plain(st.p.double(), wv.double(), ng, periodic=True)
    scale = float(exact.abs().max())
    assert float((rho.double() - plain.double()).abs().max()) <= 2e-5 * scale
    assert float((rho.double() - exact).abs().max()) <= 2e-5 * scale
    assert float((plain.double() - exact).abs().max()) <= 2e-5 * scale


def _block_field(rho: np.ndarray, c: float, threads: int) -> np.ndarray:
    """csrc/explicit.cu's field solve in numpy: thread t owns the run
    [t npt, (t + 1) npt) of nodes (npt = ceil(ng / threads)); a warp scans
    its threads' float64 run sums, and the warps' totals and their sums of
    rho_k (ng - k) are added in warp order. With P the prefix sum of rho,
    m = sum(rho) / ng (a product with 1 / ng, as the kernel takes it),
    T_i = P_i - (i + 1) m, mean(T) = sum_k rho_k (ng - k) / ng -
    m (ng + 1) / 2 and d = T - mean(T): e_i = c (d_i + d_i - (rho_i - m))."""
    ng = rho.shape[0]
    npt = -(-ng // threads)
    r = rho.astype(np.float64)
    runs = [(min(t * npt, ng), min(t * npt + npt, ng)) for t in range(threads)]
    a = np.array([r[lo:hi].sum() for lo, hi in runs])
    wt = np.array([np.sum(r[lo:hi] * (ng - np.arange(lo, hi))) for lo, hi in runs])
    warp_a, warp_wt = a.reshape(-1, 32), wt.reshape(-1, 32)
    tot = warp_a.sum(axis=1)
    base = np.concatenate([[0.0], np.cumsum(tot)[:-1]])
    ex = (base[:, None] + np.cumsum(warp_a, axis=1) - warp_a).reshape(-1)
    inv_ng = 1.0 / ng
    mean = tot.sum() * inv_ng
    mean_t = warp_wt.sum() * inv_ng - mean * (0.5 * (ng + 1))
    e = np.zeros(ng, np.float32)
    for (lo, hi), run in zip(runs, ex):
        for i in range(lo, hi):
            run += r[i]
            d = (run - (i + 1) * mean) - mean_t
            e[i] = np.float32(c * (d + (d - (r[i] - mean))))
    return e


@pytest.mark.parametrize("ng", [2, 33, 200, 511, 512, 513, 777, 1000, 1023, 1024])
def test_block_solve_is_field_from_rho(ng):
    """The kernel's pointwise form of the field (one prefix sum, two sums)
    gives the field of field_from_rho_plain (the first port's block scan
    of rho - mean in float64) to float32 rounding: 1e-6 of the largest
    node. rho is a two-stream-like density, a mean of 50 a node with
    fluctuations; at ng = 2 the field is 0 up to float64 rounding. Up to
    ng = 512 a thread owns one node, past it two (the last run short at
    odd ng)."""
    rng = np.random.default_rng(ng)
    rho = (50.0 + rng.normal(0.0, 7.0, ng)
           + 5.0 * np.cos(2 * np.pi * np.arange(ng) / ng)).astype(np.float32)
    dx = 0.05
    c = cuda_cic._solve_coef(dx)
    got = _block_field(rho, c, cuda_cic.RESIDENT_EXPLICIT_THREADS)
    ref = cuda_cic.field_from_rho_plain(torch.from_numpy(rho), dx).numpy()
    if ng == 2:
        assert np.abs(got).max() < 1e-9 * c * np.abs(rho).max()
        assert np.abs(ref).max() < 1e-9 * c * np.abs(rho).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


def test_split_cuts_apply_to_the_kernel_source():
    """tools/resident_split.py --kernel explicit cuts stages out of
    csrc/explicit.cu by text edits; each anchor must be in the source
    exactly once, and each cut leaves the launcher's name."""
    from pypic_tpu_torch.ops import _build
    from pypic_tpu_torch.tools import resident_split

    src = (_build.CSRC_DIR / "explicit.cu").read_text()
    cut = resident_split._edited(src, resident_split._EXPLICIT_EDITS)
    assert "int pypic_explicit_resident(" in cut
    assert "#define CUT 0" in cut and "#if CLUSTER_SYNC" in cut
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited(src.replace("mbar_wait(smem_u32(bars + b)", "x"),
                               resident_split._EXPLICIT_EDITS)
    assert set(resident_split.EXPLICIT_CUTS.values()) == set(range(8))
