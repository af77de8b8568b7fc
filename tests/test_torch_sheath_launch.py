"""The sheath kernels' launch shape and padded outputs, on the CPU.

``cuda_sheath.launch_shape(n, ng, sms)`` fixes the grid of the Picard pass
and the finalize on the card, and with it the order of every sum of their
deterministic current: it must cover the rows once and in order, give the
same shape for the same arguments, fit the card's shared memory up to the
small mode's ceiling on ng (MAX_NG), keep the shapes it had there, take
the large mode above it with a bounded scratch, and raise only above
LARGE_MAX_NG. The wrappers return their (n,) outputs as views of
row-padded buffers (``cuda_cic.padded_rows``) on either device; on the CPU
those carry the plain versions' values.
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch.ops import cuda_cic, cuda_rng, cuda_sheath

NS = (1, 31, 1_000_000, 1_000_003)
NGS = (2, 11, 51, 1760)
SMS = (132, 114)  # H100 SXM, H100 PCIe
# the large mode: just above the two ceilings (the pass's 1,760, the
# deterministic deposit's 1,815), where the field stops fitting shared
# memory (58,112 before FIELD_SMEM_MAX_NG left room for static shared
# memory), the phase-40 sizes and LARGE_MAX_NG
NGS_LARGE = (1761, 1816, 8192, 58_112, 58_113, 65_536, 1 << 20, 1 << 22)

# cuda_sheath.launch_shape as the small mode had it before the large mode
# was added (its values computed then and frozen here)
SHAPES_PR20 = {  # (n, ng, sms, field): (blocks, threads, rows_per_block, smem)
    (1, 2, 132, True): (1, 1024, 4, 8200), (1, 2, 114, True): (1, 1024, 4, 8200),
    (1, 11, 132, True): (1, 1024, 4, 45100), (1, 11, 114, True): (1, 1024, 4, 45100),
    (1, 51, 132, True): (1, 512, 4, 104652), (1, 51, 114, True): (1, 512, 4, 104652),
    (1, 1760, 132, True): (1, 32, 4, 232320), (1, 1760, 114, True): (1, 32, 4, 232320),
    (31, 2, 132, True): (1, 1024, 32, 8200), (31, 2, 114, True): (1, 1024, 32, 8200),
    (31, 11, 132, True): (1, 1024, 32, 45100), (31, 11, 114, True): (1, 1024, 32, 45100),
    (31, 51, 132, True): (1, 512, 32, 104652), (31, 51, 114, True): (1, 512, 32, 104652),
    (31, 1760, 132, True): (1, 32, 32, 232320), (31, 1760, 114, True): (1, 32, 32, 232320),
    (1000000, 2, 132, True): (245, 1024, 4084, 8200), (1000000, 2, 114, True): (228, 1024, 4388, 8200),
    (1000000, 11, 132, True): (245, 1024, 4084, 45100), (1000000, 11, 114, True): (228, 1024, 4388, 45100),
    (1000000, 51, 132, True): (264, 512, 3788, 104652), (1000000, 51, 114, True): (228, 512, 4388, 104652),
    (1000000, 1760, 132, True): (132, 32, 7576, 232320), (1000000, 1760, 114, True): (114, 32, 8772, 232320),
    (1000003, 2, 132, True): (245, 1024, 4084, 8200), (1000003, 2, 114, True): (228, 1024, 4388, 8200),
    (1000003, 11, 132, True): (245, 1024, 4084, 45100), (1000003, 11, 114, True): (228, 1024, 4388, 45100),
    (1000003, 51, 132, True): (264, 512, 3788, 104652), (1000003, 51, 114, True): (228, 512, 4388, 104652),
    (1000003, 1760, 132, True): (132, 32, 7576, 232320), (1000003, 1760, 114, True): (114, 32, 8772, 232320),
    (1, 2, 132, False): (1, 1024, 4, 8192), (1, 2, 114, False): (1, 1024, 4, 8192),
    (1, 11, 132, False): (1, 1024, 4, 45056), (1, 11, 114, False): (1, 1024, 4, 45056),
    (1, 51, 132, False): (1, 512, 4, 104448), (1, 51, 114, False): (1, 512, 4, 104448),
    (1, 128, 132, False): (1, 128, 4, 65536), (1, 128, 114, False): (1, 128, 4, 65536),
    (1, 1816, 132, False): (1, 32, 4, 232448), (1, 1816, 114, False): (1, 32, 4, 232448),
    (31, 2, 132, False): (1, 1024, 32, 8192), (31, 2, 114, False): (1, 1024, 32, 8192),
    (31, 11, 132, False): (1, 1024, 32, 45056), (31, 11, 114, False): (1, 1024, 32, 45056),
    (31, 51, 132, False): (1, 512, 32, 104448), (31, 51, 114, False): (1, 512, 32, 104448),
    (31, 128, 132, False): (1, 128, 32, 65536), (31, 128, 114, False): (1, 128, 32, 65536),
    (31, 1816, 132, False): (1, 32, 32, 232448), (31, 1816, 114, False): (1, 32, 32, 232448),
    (1000000, 2, 132, False): (245, 1024, 4084, 8192), (1000000, 2, 114, False): (228, 1024, 4388, 8192),
    (1000000, 11, 132, False): (245, 1024, 4084, 45056), (1000000, 11, 114, False): (228, 1024, 4388, 45056),
    (1000000, 51, 132, False): (264, 512, 3788, 104448), (1000000, 51, 114, False): (228, 512, 4388, 104448),
    (1000000, 128, 132, False): (264, 128, 3788, 65536), (1000000, 128, 114, False): (228, 128, 4388, 65536),
    (1000000, 1816, 132, False): (132, 32, 7576, 232448), (1000000, 1816, 114, False): (114, 32, 8772, 232448),
    (1000003, 2, 132, False): (245, 1024, 4084, 8192), (1000003, 2, 114, False): (228, 1024, 4388, 8192),
    (1000003, 11, 132, False): (245, 1024, 4084, 45056), (1000003, 11, 114, False): (228, 1024, 4388, 45056),
    (1000003, 51, 132, False): (264, 512, 3788, 104448), (1000003, 51, 114, False): (228, 512, 4388, 104448),
    (1000003, 128, 132, False): (264, 128, 3788, 65536), (1000003, 128, 114, False): (228, 128, 4388, 65536),
    (1000003, 1816, 132, False): (132, 32, 7576, 232448), (1000003, 1816, 114, False): (114, 32, 8772, 232448),
}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("ng", NGS)
@pytest.mark.parametrize("n", NS)
def test_launch_shape_covers_the_rows_once_in_order(n, ng, sms):
    shape = cuda_sheath.launch_shape(n, ng, sms)
    r = shape.rows_per_block
    ranges = [(b * r, min(n, (b + 1) * r)) for b in range(shape.blocks)]
    assert len(ranges) == shape.blocks
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert hi == nxt
    assert all(hi > lo for lo, hi in ranges)  # every block gets rows
    assert shape.rows_per_block % 4 == 0  # 16-B accesses stay aligned
    assert shape.threads in (32, 64, 128, 256, 512, 1024)
    assert 1 <= shape.blocks <= cuda_sheath.MAX_BLOCKS_PER_SM * sms


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("ng", NGS)
@pytest.mark.parametrize("n", NS)
def test_launch_shape_is_a_function_of_n_ng_and_sms(n, ng, sms):
    a = cuda_sheath.launch_shape(n, ng, sms)
    assert a == cuda_sheath.launch_shape(n, ng, sms)
    # the row's shape (n = 1e6, ng = 51) on an H100 SXM: two blocks of 512
    # an SM, 264 blocks
    if (n, ng, sms) == (1_000_000, 51, 132):
        assert (a.blocks, a.threads, a.rows_per_block) == (264, 512, 3788)


@pytest.mark.parametrize("sms", SMS)
def test_launch_shape_fits_shared_memory_up_to_the_ceiling(sms):
    """Every ng from 2 to the ceiling: a block's field and columns fit its
    shared memory, and the blocks an SM holds fit the SM's."""
    assert cuda_sheath.MAX_NG >= 1760  # the first port's ceiling
    for ng in range(2, cuda_sheath.MAX_NG + 1):
        shape = cuda_sheath.launch_shape(1_000_000, ng, sms)
        assert shape.smem == (shape.threads + 1) * ng * 4
        assert shape.smem + cuda_sheath.SMALL_STATIC_BYTES <= cuda_cic.SMEM_LIMIT
        per_sm = -(-shape.blocks // sms)
        assert per_sm * (shape.smem + cuda_sheath.BLOCK_RESERVED) <= cuda_sheath.SM_SHARED
        assert per_sm * shape.threads <= cuda_sheath.SM_THREADS


@pytest.mark.parametrize("sms", SMS)
def test_launch_shape_raises_above_the_ceiling(sms):
    """One node above the small mode's ceiling is the large mode; the
    ceiling that raises is LARGE_MAX_NG (>= 2^22), with and without the
    field."""
    assert cuda_sheath.LARGE_MAX_NG >= 1 << 22
    assert cuda_sheath.launch_shape(1_000_000, cuda_sheath.MAX_NG + 1, sms).large
    for field in (True, False):
        top = cuda_sheath.LARGE_MAX_NG
        assert cuda_sheath.launch_shape(1_000_000, top, sms, field=field).large
        with pytest.raises(ValueError, match="LARGE_MAX_NG"):
            cuda_sheath.launch_shape(1_000_000, top + 1, sms, field=field)


@pytest.mark.parametrize("field", [True, False], ids=["pass", "deposit_det"])
def test_small_shapes_are_unchanged(field):
    """At every (n, ng, sms) of the frozen table the small mode's shape is
    the one it was before the large mode came: blocks, threads, rows a
    block and shared memory, so its sums keep their order and bits; except
    the ones the card refused: deposit_det at 1,816 nodes asked for
    232,448 B beside det_flush's 16 static bytes, above a block's
    SMEM_LIMIT; it takes the large mode there now."""
    cases = {k: v for k, v in SHAPES_PR20.items() if k[3] == field}
    assert len(cases) == len(NS) * len(SMS) * (4 if field else 5)
    refused = 0
    for (n, ng, sms, _), want in cases.items():
        got = cuda_sheath.launch_shape(n, ng, sms, field=field)
        if want[3] + cuda_sheath.SMALL_STATIC_BYTES > cuda_cic.SMEM_LIMIT:
            refused += 1
            assert (ng, field, got.large, got.smem) == (1816, False, True, 0)
            continue
        assert not got.large
        assert (got.blocks, got.threads, got.rows_per_block, got.smem) == want
    assert refused == (0 if field else len(NS) * len(SMS))


@pytest.mark.parametrize("field", [True, False], ids=["pass", "deposit_det"])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("ng", NGS_LARGE)
@pytest.mark.parametrize("n", NS + (10_000_000,))
def test_large_shape_covers_the_rows_once(n, ng, sms, field):
    """The large mode's grid: a function of (n, ng, sms) alone, every row in
    exactly one block's contiguous range (ranges of a multiple of 4 rows,
    every block with rows), LARGE_THREADS threads, at most two blocks an
    SM; shared memory the field alone where it fits (ng <= FIELD_SMEM_MAX_NG; none
    for the deterministic deposit) and the blocks an SM holds fit the SM;
    the scratch 8 ng + 4 blocks bytes: no column of ng a thread or a
    block."""
    shape = cuda_sheath.launch_shape(n, ng, sms, field=field)
    small_top = cuda_sheath.MAX_NG if field else (
        cuda_cic.SMEM_LIMIT - cuda_sheath.SMALL_STATIC_BYTES) // 128
    assert shape.large == (ng > small_top)
    if not shape.large:
        return
    assert shape == cuda_sheath.launch_shape(n, ng, sms, field=field)
    r = shape.rows_per_block
    assert r % 4 == 0 and (shape.blocks - 1) * r < n <= shape.blocks * r
    assert shape.threads == cuda_sheath.LARGE_THREADS
    assert 1 <= shape.blocks <= cuda_sheath.MAX_BLOCKS_PER_SM * sms
    fits = field and ng <= cuda_cic.FIELD_SMEM_MAX_NG
    assert shape.smem == (4 * ng if fits else 0) <= cuda_cic.SMEM_LIMIT
    per_sm = -(-shape.blocks // sms)
    assert per_sm * (shape.smem + cuda_sheath.BLOCK_RESERVED) <= cuda_sheath.SM_SHARED
    assert shape.scratch == 8 * ng + 4 * shape.blocks


def test_large_scratch_bytes():
    """The large mode's scratch at the stated sizes (n = 1e7, the H100's
    132 SMs): 525,344 B at ng = 65,536 and 33,555,488 B at 2^22 (the
    small mode's partials would be 264 x 2^22 floats there, 4.4 GB)."""
    for ng, want in ((65_536, 525_344), (1 << 22, 33_555_488)):
        for field in (True, False):
            shape = cuda_sheath.launch_shape(10_000_000, ng, 132, field=field)
            assert shape.scratch == want
            assert shape.scratch <= 8 * ng + 4 * cuda_sheath.MAX_BLOCKS_PER_SM * 132


def _aligned_views(outs):
    for t in outs:
        assert t.dim() == 1 and t.is_contiguous()
        assert t.data_ptr() % 16 == 0


def _pass_inputs(n, ng, seed=4):
    rng = np.random.default_rng(seed)
    cells = float(ng - 1)
    p0 = rng.uniform(0.0, cells, n).astype(np.float32)
    ps = np.clip(p0 + rng.normal(0, 0.2, n), -0.5, cells + 0.5).astype(np.float32)
    qm = np.full(n, -1.76e11, np.float32)
    u0 = rng.normal(0, 1.3e6, n).astype(np.float32)
    w = np.full(n, -1.602e-10, np.float32)
    act = rng.choice(np.asarray([1.0, 0.0, -1.0], np.float32), n, p=[0.9, 0.05, 0.05])
    es = (rng.normal(size=ng) * 2e4).astype(np.float32)
    return [torch.from_numpy(a) for a in (es, ps, p0, u0, qm, w, act)]


@pytest.mark.parametrize("final", [False, True], ids=["picard", "finalize"])
@pytest.mark.parametrize("n", [1, 31, 1_000_003])
def test_sheath_pass_outputs_are_padded_views_of_the_plain_values(n, final):
    args = _pass_inputs(n, 51)
    kw = dict(dt=1e-12, dx=1e-5)
    fn = cuda_sheath.sheath_finalize if final else cuda_sheath.sheath_picard
    plain = (cuda_sheath.sheath_finalize_plain if final
             else cuda_sheath.sheath_picard_plain)
    got, ref = fn(*args, **kw), plain(*args, **kw)
    _aligned_views(got[:-1])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("gamma", [0.0, 0.5])
@pytest.mark.parametrize("n", [1, 31, 1_000_003])
def test_sheath_reinject_outputs_are_padded_views_of_the_plain_values(n, gamma):
    rng = np.random.default_rng(9)
    p = rng.uniform(0, 50, n).astype(np.float32)
    v = rng.normal(0, 1e5, (3, n)).astype(np.float32)
    act = rng.choice(np.asarray([1.0, 0.0, -1.0], np.float32), n, p=[0.8, 0.1, 0.1])
    sig = np.full(n, 1.3e6, np.float32)
    arrs = [torch.from_numpy(a) for a in (p, v[0], v[1], v[2], act, sig)]
    got = cuda_rng.sheath_reinject((3, 4), 17, *arrs, cells=50.0, gamma=gamma)
    ref = cuda_rng.sheath_reinject_plain((3, 4), 17, *arrs, cells=50.0,
                                         gamma=gamma)
    _aligned_views(got)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1_000_003])
def test_padded_rows_pitch(n):
    outs = cuda_cic.padded_rows(3, n, "cpu")
    _aligned_views(outs)
    assert all(t.shape == (n,) for t in outs)
    pitch = outs[1].data_ptr() - outs[0].data_ptr()
    assert pitch == 4 * (-(-n // 4) * 4)
