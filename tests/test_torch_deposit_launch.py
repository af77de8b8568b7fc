"""The magnetized deposits' launch shape, on the CPU.

``cuda_cic.deposit_launch_shape(n, ng, field, sms)`` fixes the grid of
``deposit2`` (``field`` False) and ``boris_gather_push_deposit`` (True) on
the card: wide (one block of 1,024 threads an SM, each over a contiguous
range of rows, four rows a thread and pass, lane columns) or narrow (the
first port's grid: a row a thread, grid-stride, one column). Every row
must fall in one block and every block get rows; the shape must fit the
card's shared memory, keep the first port's ceilings (one column a node:
ng <= 29,056 for deposit2, 19,370 with the field) and raise just above
them.
"""

import numpy as np
import pytest

from pypic_tpu_torch.ops import cuda_cic

NS = (1, 16_384, 50_000, 999_996, 1_000_003)
NGS = (2, 600, 800, 29_056)
SMS = (132, 114)  # H100 SXM, H100 PCIe
CEILING = {False: 29_056, True: 19_370}  # SMEM_LIMIT // 8 and // 12


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("field", [False, True], ids=["deposit2", "boris"])
@pytest.mark.parametrize("ng", NGS)
@pytest.mark.parametrize("n", NS)
def test_launch_shape_covers_the_rows_once(n, ng, field, sms):
    if ng > CEILING[field]:
        with pytest.raises(ValueError, match="shared memory"):
            cuda_cic.deposit_launch_shape(n, ng, field, sms)
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
    top = CEILING[field]
    assert top == cuda_cic.SMEM_LIMIT // (4 * (3 if field else 2))
    shape = cuda_cic.deposit_launch_shape(999_996, top, field, 132)
    assert shape.cols == 1 and shape.smem <= cuda_cic.SMEM_LIMIT
    assert cuda_cic.deposit_launch_shape(1_000, top, field, 132).smem <= cuda_cic.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        cuda_cic.deposit_launch_shape(999_996, top + 1, field, 132)


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
