"""The magnetized deposits' launch shape, on the CPU.

``cuda_cic.deposit_launch_shape(n, ng, field, sms)`` fixes the grid of
``deposit2`` (``field`` False) and ``boris_gather_push_deposit`` (True) on
the card: wide (one block of 1,024 threads an SM, each over a contiguous
range of rows, four rows a thread and pass, lane columns) or narrow (the
first port's grid: a row a thread, grid-stride, one column). Every row
must fall in one block and every block get rows; the shape must fit the
card's shared memory, keep its shapes up to the columns' ceilings (one
column a node: ng <= 29,056 for deposit2, 19,370 with the field), take the
large mode just above them (no shared histogram, the field alone in
shared memory where it fits) and raise only above LARGE_MAX_NG; the
single ``deposit`` (one histogram) still raises above 58,112.
"""

import numpy as np
import pytest

from pypic_tpu_torch.ops import cuda_cic

NS = (1, 16_384, 50_000, 999_996, 1_000_003)
NGS = (2, 600, 800, 29_056)
SMS = (132, 114)  # H100 SXM, H100 PCIe
CEILING = {False: 29_056, True: 19_370}  # SMEM_LIMIT // 8 and // 12
# the large mode: just above each ceiling, where the field stops fitting
# shared memory alone (58,112), the phase-40 sizes and LARGE_MAX_NG
NGS_LARGE = (19_371, 29_057, 32_768, 58_112, 58_113, 65_536, 1 << 20, 1 << 22)

# deposit_launch_shape as it was before the large mode was added (its
# values computed then and frozen here)
SHAPES_PR20 = {  # (n, ng, field, sms): (rows, blocks, threads, cols, smem)
    (1, 2, False, 132): (1, 1, 256, 1, 16), (1, 2, False, 114): (1, 1, 256, 1, 16),
    (1, 2, True, 132): (1, 1, 256, 1, 24), (1, 2, True, 114): (1, 1, 256, 1, 24),
    (1, 600, False, 132): (1, 1, 256, 1, 4800), (1, 600, False, 114): (1, 1, 256, 1, 4800),
    (1, 600, True, 132): (1, 1, 256, 1, 7200), (1, 600, True, 114): (1, 1, 256, 1, 7200),
    (1, 800, False, 132): (1, 1, 256, 1, 6400), (1, 800, False, 114): (1, 1, 256, 1, 6400),
    (1, 800, True, 132): (1, 1, 256, 1, 9600), (1, 800, True, 114): (1, 1, 256, 1, 9600),
    (1, 19370, False, 132): (1, 1, 256, 1, 154960), (1, 19370, False, 114): (1, 1, 256, 1, 154960),
    (1, 19370, True, 132): (1, 1, 256, 1, 232440), (1, 19370, True, 114): (1, 1, 256, 1, 232440),
    (1, 29056, False, 132): (1, 1, 256, 1, 232448), (1, 29056, False, 114): (1, 1, 256, 1, 232448),
    (16384, 2, False, 132): (1, 64, 256, 1, 16), (16384, 2, False, 114): (1, 64, 256, 1, 16),
    (16384, 2, True, 132): (1, 64, 256, 1, 24), (16384, 2, True, 114): (1, 64, 256, 1, 24),
    (16384, 600, False, 132): (1, 64, 256, 1, 4800), (16384, 600, False, 114): (1, 64, 256, 1, 4800),
    (16384, 600, True, 132): (1, 64, 256, 1, 7200), (16384, 600, True, 114): (1, 64, 256, 1, 7200),
    (16384, 800, False, 132): (1, 64, 256, 1, 6400), (16384, 800, False, 114): (1, 64, 256, 1, 6400),
    (16384, 800, True, 132): (1, 64, 256, 1, 9600), (16384, 800, True, 114): (1, 64, 256, 1, 9600),
    (16384, 19370, False, 132): (1, 64, 256, 1, 154960), (16384, 19370, False, 114): (1, 64, 256, 1, 154960),
    (16384, 19370, True, 132): (1, 64, 256, 1, 232440), (16384, 19370, True, 114): (1, 64, 256, 1, 232440),
    (16384, 29056, False, 132): (1, 64, 256, 1, 232448), (16384, 29056, False, 114): (1, 64, 256, 1, 232448),
    (50000, 2, False, 132): (1, 196, 256, 1, 16), (50000, 2, False, 114): (1, 196, 256, 1, 16),
    (50000, 2, True, 132): (1, 196, 256, 1, 24), (50000, 2, True, 114): (1, 196, 256, 1, 24),
    (50000, 600, False, 132): (1, 196, 256, 1, 4800), (50000, 600, False, 114): (1, 196, 256, 1, 4800),
    (50000, 600, True, 132): (1, 196, 256, 1, 7200), (50000, 600, True, 114): (1, 196, 256, 1, 7200),
    (50000, 800, False, 132): (1, 196, 256, 1, 6400), (50000, 800, False, 114): (1, 196, 256, 1, 6400),
    (50000, 800, True, 132): (1, 196, 256, 1, 9600), (50000, 800, True, 114): (1, 196, 256, 1, 9600),
    (50000, 19370, False, 132): (1, 196, 256, 1, 154960), (50000, 19370, False, 114): (1, 196, 256, 1, 154960),
    (50000, 19370, True, 132): (1, 196, 256, 1, 232440), (50000, 19370, True, 114): (1, 196, 256, 1, 232440),
    (50000, 29056, False, 132): (1, 196, 256, 1, 232448), (50000, 29056, False, 114): (1, 196, 256, 1, 232448),
    (999996, 2, False, 132): (4, 132, 1024, 32, 512), (999996, 2, False, 114): (4, 114, 1024, 32, 512),
    (999996, 2, True, 132): (4, 132, 1024, 32, 520), (999996, 2, True, 114): (4, 114, 1024, 32, 520),
    (999996, 600, False, 132): (4, 132, 1024, 32, 153600), (999996, 600, False, 114): (4, 114, 1024, 32, 153600),
    (999996, 600, True, 132): (4, 132, 1024, 32, 156000), (999996, 600, True, 114): (4, 114, 1024, 32, 156000),
    (999996, 800, False, 132): (4, 132, 1024, 32, 204800), (999996, 800, False, 114): (4, 114, 1024, 32, 204800),
    (999996, 800, True, 132): (4, 132, 1024, 32, 208000), (999996, 800, True, 114): (4, 114, 1024, 32, 208000),
    (999996, 19370, False, 132): (4, 132, 1024, 1, 154960), (999996, 19370, False, 114): (4, 114, 1024, 1, 154960),
    (999996, 19370, True, 132): (4, 132, 1024, 1, 232440), (999996, 19370, True, 114): (4, 114, 1024, 1, 232440),
    (999996, 29056, False, 132): (4, 132, 1024, 1, 232448), (999996, 29056, False, 114): (4, 114, 1024, 1, 232448),
    (1000003, 2, False, 132): (4, 132, 1024, 32, 512), (1000003, 2, False, 114): (4, 114, 1024, 32, 512),
    (1000003, 2, True, 132): (4, 132, 1024, 32, 520), (1000003, 2, True, 114): (4, 114, 1024, 32, 520),
    (1000003, 600, False, 132): (4, 132, 1024, 32, 153600), (1000003, 600, False, 114): (4, 114, 1024, 32, 153600),
    (1000003, 600, True, 132): (4, 132, 1024, 32, 156000), (1000003, 600, True, 114): (4, 114, 1024, 32, 156000),
    (1000003, 800, False, 132): (4, 132, 1024, 32, 204800), (1000003, 800, False, 114): (4, 114, 1024, 32, 204800),
    (1000003, 800, True, 132): (4, 132, 1024, 32, 208000), (1000003, 800, True, 114): (4, 114, 1024, 32, 208000),
    (1000003, 19370, False, 132): (4, 132, 1024, 1, 154960), (1000003, 19370, False, 114): (4, 114, 1024, 1, 154960),
    (1000003, 19370, True, 132): (4, 132, 1024, 1, 232440), (1000003, 19370, True, 114): (4, 114, 1024, 1, 232440),
    (1000003, 29056, False, 132): (4, 132, 1024, 1, 232448), (1000003, 29056, False, 114): (4, 114, 1024, 1, 232448),
}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("field", [False, True], ids=["deposit2", "boris"])
@pytest.mark.parametrize("ng", NGS)
@pytest.mark.parametrize("n", NS)
def test_launch_shape_covers_the_rows_once(n, ng, field, sms):
    if ng > CEILING[field]:  # the large mode: test_large_shape_covers_the_rows_once
        assert cuda_cic.deposit_launch_shape(n, ng, field, sms).cols == 0
        return
    shape = cuda_cic.deposit_launch_shape(n, ng, field, sms)
    block = cuda_cic.deposit_row_blocks(n, ng, field, sms)
    assert block.shape == (n,)
    assert block.min() >= 0 and block.max() < shape.blocks
    counts = np.bincount(block, minlength=shape.blocks)
    assert (counts > 0).all()  # every block gets rows
    if shape.rows == 4:  # wide: one block an SM, every thread a group of four
        assert (shape.blocks, shape.threads) == (sms, cuda_cic.DEPOSIT_WIDE_THREADS)
        assert (np.diff(block) >= 0).all()  # contiguous ranges, in order
        starts = np.flatnonzero(np.diff(block)) + 1
        assert (starts % 4 == 0).all()  # 16-B accesses stay aligned
        assert counts.min() >= 4 * shape.threads
    else:  # narrow: the first port's grid
        assert (shape.rows, shape.threads, shape.cols) == (
            1, cuda_cic.DEPOSIT_NARROW_THREADS, 1)
        assert shape.blocks <= 8 * sms
    assert shape.cols in (1, 2, 4, 8, 16, 32)
    assert shape.smem == 4 * (2 * shape.cols + int(field)) * ng
    assert shape.smem <= cuda_cic.SMEM_LIMIT
    assert shape == cuda_cic.deposit_launch_shape(n, ng, field, sms)


@pytest.mark.parametrize("field", [False, True], ids=["deposit2", "boris"])
def test_launch_shape_keeps_the_ceilings(field):
    """The columns' ceiling is where it was (one column, shared memory
    full); one node above it is the large mode (cols 0), and the limit
    that raises is LARGE_MAX_NG (>= 2^22); the single deposit still raises
    above 58,112 (ROADMAP item 10)."""
    top = CEILING[field]
    assert top == cuda_cic.SMEM_LIMIT // (4 * (3 if field else 2))
    shape = cuda_cic.deposit_launch_shape(999_996, top, field, 132)
    assert shape.cols == 1 and shape.smem <= cuda_cic.SMEM_LIMIT
    assert cuda_cic.deposit_launch_shape(1_000, top, field, 132).smem <= cuda_cic.SMEM_LIMIT
    for n in (1_000, 999_996):
        assert cuda_cic.deposit_launch_shape(n, top + 1, field, 132).cols == 0
    big = cuda_cic.LARGE_MAX_NG
    assert big >= 1 << 22
    assert cuda_cic.deposit_launch_shape(999_996, big, field, 132).cols == 0
    with pytest.raises(ValueError, match="LARGE_MAX_NG"):
        cuda_cic.deposit_launch_shape(999_996, big + 1, field, 132)
    single = cuda_cic.SMEM_LIMIT // 4
    assert cuda_cic.deposit_launch_shape(999_996, single, False, 132, hists=1).cols == 1
    with pytest.raises(ValueError, match="item 10"):
        cuda_cic.deposit_launch_shape(999_996, single + 1, False, 132, hists=1)


def test_small_shapes_are_unchanged():
    """Up to the ceilings every shape of the frozen table is the one it was
    before the large mode came (rows, blocks, threads, columns, shared
    memory)."""
    assert len(SHAPES_PR20) == 90
    for (n, ng, field, sms), want in SHAPES_PR20.items():
        s = cuda_cic.deposit_launch_shape(n, ng, field, sms)
        assert (s.rows, s.blocks, s.threads, s.cols, s.smem) == want


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("field", [False, True], ids=["deposit2", "boris"])
@pytest.mark.parametrize("ng", NGS_LARGE)
@pytest.mark.parametrize("n", NS)
def test_large_shape_covers_the_rows_once(n, ng, field, sms):
    """The large mode (above the ceilings): a function of (n, ng, sms)
    alone, the small mode's rows a block (wide or narrow, every row in one
    block, every block with rows), no shared histogram (cols 0), shared
    memory the field alone where it fits (ng <= 58,112) and none else: no
    scratch of any kind."""
    shape = cuda_cic.deposit_launch_shape(n, ng, field, sms)
    if ng <= CEILING[field]:
        assert shape.cols == 1
        return
    assert shape == cuda_cic.deposit_launch_shape(n, ng, field, sms)
    assert shape.cols == 0
    fits = field and ng <= cuda_cic.FIELD_SMEM_MAX_NG
    assert shape.smem == (4 * ng if fits else 0) <= cuda_cic.SMEM_LIMIT
    block = cuda_cic.deposit_row_blocks(n, ng, field, sms)
    counts = np.bincount(block, minlength=shape.blocks)
    assert block.shape == (n,) and (counts > 0).all()
    if shape.rows == 4:
        assert (shape.blocks, shape.threads) == (sms, cuda_cic.DEPOSIT_WIDE_THREADS)
        assert (np.diff(block) >= 0).all()
        assert ((np.flatnonzero(np.diff(block)) + 1) % 4 == 0).all()
    else:
        assert (shape.threads, shape.blocks) == (
            cuda_cic.DEPOSIT_NARROW_THREADS, max(1, min(-(-n // 256), 8 * sms)))


def test_launch_shape_of_the_rows():
    """The rows' shapes on an H100 SXM: configs[3] (n = 999,996, ng = 600)
    wide, 132 blocks with 32 lane columns; the D-N row (50,000, ng = 800)
    and the carried patch (16,384, ng = 600) narrow, as many blocks of 256
    as their rows fill; the width changes where 132 x 1,024 threads get
    four rows each."""
    for field in (False, True):
        big = cuda_cic.deposit_launch_shape(999_996, 600, field, 132)
        assert (big.rows, big.blocks, big.threads, big.cols) == (4, 132, 1024, 32)
    assert cuda_cic.deposit_launch_shape(50_000, 800, False, 132).blocks == 196
    assert cuda_cic.deposit_launch_shape(16_384, 600, False, 132).blocks == 64
    assert cuda_cic.deposit_launch_shape(4 * 1024 * 132, 600, False, 132).rows == 4
    assert cuda_cic.deposit_launch_shape(4 * 1024 * 132 - 1, 600, False, 132).rows == 1
    # the columns halve where shared memory cannot hold 32 (ng = 800: 32
    # columns of two arrays are 204,800 B; ng = 1,000 with the field: 16)
    assert cuda_cic.deposit_launch_shape(999_996, 800, False, 132).cols == 32
    assert cuda_cic.deposit_launch_shape(999_996, 1_000, True, 132).cols == 16


def test_split_cuts_apply_to_the_kernel_source():
    """tools/resident_split.py --kernel deposit2|boris_deposit cuts stages
    out of csrc/magnetized.cu, cic_common.cuh's flush inlined, by text
    edits; each anchor must be in the source as often as the edit says, a
    changed source fails loudly, and the first port's edits do not apply
    to the current kernels."""
    from pypic_tpu_torch.ops import _build
    from pypic_tpu_torch.tools import resident_split

    src = resident_split._inlined(_build.CSRC_DIR / "magnetized.cu")
    cut = resident_split._edited(src, resident_split._DEPOSIT_EDITS)
    assert "int pypic_deposit2(" in cut and "int pypic_boris_gather_push_deposit(" in cut
    assert "#define CUT 0" in cut and cut.count("float sink = 0.0f;") == 2
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited(src.replace("zero_shared(h_r, 2 * ng * cols);", "x"),
                               resident_split._DEPOSIT_EDITS)
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited((_build.CSRC_DIR / "magnetized.cu").read_text(),
                               resident_split._DEPOSIT_FIRST_PORT_EDITS)
    assert set(resident_split.DEPOSIT_CUTS.values()) == set(range(5))
