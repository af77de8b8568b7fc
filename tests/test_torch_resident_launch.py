"""The resident implicit kernel's launch shape, on the CPU.

``cuda_cic.implicit_resident_shape(n, ng)`` fixes the launch of
``csrc/implicit.cu``: one cluster of 16 CTAs x 1024 threads, CTA r owning a
contiguous range of rows and each thread at most 8 of them in registers.
The partition sets the order of the kernel's sums, so it must depend on
(n, ng) alone, cover every row once, fit the card's shared memory for every
ng the kernel takes, and raise where the kernel cannot run.
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch.engines import implicit
from pypic_tpu_torch.ops import cuda_cic
from pypic_tpu_torch.tools import landau

RAGGED_NS = (9001, 100_000, 131_071, 131_072)


@pytest.mark.parametrize("ng", [2, 200, 1024])
@pytest.mark.parametrize("n", RAGGED_NS)
def test_launch_shape(n, ng):
    shape = cuda_cic.implicit_resident_shape(n, ng)
    assert (shape.cluster, shape.threads) == (16, 1024)
    assert shape.cluster == cuda_cic.RESIDENT_IMPLICIT_CLUSTER
    assert shape.per_cta == -(-n // 16)
    assert shape.per_thread == -(-shape.per_cta // 1024)
    assert shape.per_thread <= cuda_cic.RESIDENT_IMPLICIT_SLOTS
    assert shape == cuda_cic.implicit_resident_shape(n, ng)
    # the configs[1] row: 6,250 particles a CTA, 7 a thread at most; the
    # largest n: 8,192 a CTA, 8 a thread
    if n == 100_000:
        assert (shape.per_cta, shape.per_thread) == (6250, 7)
    if n == 131_072:
        assert (shape.per_cta, shape.per_thread) == (8192, 8)


def test_shared_memory_fits_every_ng():
    """Every ng from 2 to 1,024 at n = 131,072: 2,240 float64, the
    deposit's columns, 41 float32 a node and the particles' v0 (8 x 1024
    float32), inside the 232,448 B a block may use: 32 columns a node up
    to ng = 256, then 8, halved where they do not fit (109,088 B at the
    configs[1] row's ng = 200; 2 columns and 226,816 B at 1,024, as the
    kernel's note says)."""
    for ng in range(2, cuda_cic.RESIDENT_MAX_NG_IMPLICIT + 1):
        shape = cuda_cic.implicit_resident_shape(131_072, ng)
        assert shape.smem == 8 * 2240 + 4 * ((shape.cols + 41) * ng + 8 * 1024)
        assert shape.smem <= cuda_cic.SMEM_LIMIT
        assert shape.cols in ((32,) if ng <= 256 else (8, 4, 2))
        if shape.cols < 8 and ng > 256:  # the next wider one does not fit
            assert shape.smem + 4 * shape.cols * ng > cuda_cic.SMEM_LIMIT
    assert cuda_cic.implicit_resident_shape(100_000, 200).smem == 109_088
    last = cuda_cic.implicit_resident_shape(131_072, 1024)
    assert (last.cols, last.smem) == (2, 226_816)


@pytest.mark.parametrize("n", (1, 17, 1024, *RAGGED_NS))
def test_partition_covers_every_row_once(n):
    rows = cuda_cic.implicit_resident_rows(n, 200)
    assert rows.shape == (16, 1024, cuda_cic.RESIDENT_IMPLICIT_SLOTS)
    held = rows[rows >= 0]
    assert held.size == n
    np.testing.assert_array_equal(np.sort(held), np.arange(n))


@pytest.mark.parametrize("n", RAGGED_NS)
def test_partition_gives_each_cta_a_contiguous_range(n):
    """CTA r holds rows [r per_cta, (r + 1) per_cta) clipped to n; slot j of
    thread t holds row r per_cta + j 1024 + t (coalesced loads)."""
    shape = cuda_cic.implicit_resident_shape(n, 200)
    rows = cuda_cic.implicit_resident_rows(n, 200)
    for r in range(shape.cluster):
        lo, hi = r * shape.per_cta, min((r + 1) * shape.per_cta, n)
        got = rows[r][rows[r] >= 0]
        np.testing.assert_array_equal(np.sort(got), np.arange(lo, max(lo, hi)))
        # slot-major: slot j covers the j-th 1024 rows of the CTA's range
        j_of = (rows[r] - lo) // shape.threads
        assert np.all((j_of == np.arange(rows.shape[2])[None, :])[rows[r] >= 0])
    # no thread holds a row in a slot past per_thread
    assert np.all(rows[:, :, shape.per_thread:] == -1)


@pytest.mark.parametrize("n,ng,match", [
    (131_073, 200, "n <= 131072"),
    (200_000, 200, "n <= 131072"),
    (100_000, 1025, "ng <= 1024"),
    (100_000, 2048, "ng <= 1024"),
])
def test_shape_refuses_past_the_limits(n, ng, match):
    with pytest.raises(ValueError, match=match):
        cuda_cic.implicit_resident_shape(n, ng)


def test_wrapper_refuses_past_n_limit_on_either_device():
    """The wrapper's n limit holds for CPU tensors too, as before; ng is
    limited on the card only (the plain version runs any ng)."""
    n, ng = 131_073, 64
    p = torch.zeros(n)
    e = torch.zeros(ng)
    kw = dict(qm=-1.7e11, w=-3.2e-9, ke_c=1.0, dt=1e-7, dx=0.05, tol=1e-6,
              maxiter=3, extrapolate=False, anderson=False, fe_c=1.0,
              tracer=0)
    with pytest.raises(ValueError, match="n <= 131072"):
        cuda_cic.implicit_resident(e, e, e, p, p, ng, 1, **kw)


@pytest.mark.parametrize("n,ng,match", [
    (131_073, 200, "n <= 131072"),
    (1000, 1025, "ng <= 1024"),
])
def test_engine_refuses_past_the_limits(n, ng, match):
    import dataclasses

    from pypic_tpu_torch.grid import GridSpec

    cfg = landau.config(1000)
    cfg = dataclasses.replace(cfg, grid=GridSpec(ng, cfg.grid.length, "periodic"))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, cfg.grid.length, n).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1e6, n).astype(np.float32))
    st = implicit.init_state(x, v, -1.602176634e-19, 9.1093837015e-31, cfg,
                             device="cpu")
    with pytest.raises(ValueError, match=match):
        implicit.check_resident_supported(cfg, st)


def test_split_cuts_apply_to_the_kernel_source():
    """tools/resident_split.py cuts stages out of csrc/implicit.cu by text
    edits; each anchor must be in the source exactly once, and each cut
    leaves the launcher's name and adds the forced pass counts."""
    from pypic_tpu_torch.ops import _build
    from pypic_tpu_torch.tools import resident_split

    src = (_build.CSRC_DIR / "implicit.cu").read_text()
    cut = resident_split._edited(src, resident_split._CURRENT_EDITS)
    assert "int pypic_implicit_resident(" in cut
    assert "#define CUT 0" in cut and "const int* forced" in cut
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited(src.replace("cluster.sync();  // recv", "x"),
                               resident_split._CURRENT_EDITS)
