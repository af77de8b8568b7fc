"""The sheath kernels' launch shape and padded outputs, on the CPU.

``cuda_sheath.launch_shape(n, ng, sms)`` fixes the grid of the Picard pass
and the finalize on the card, and with it the order of every sum of their
deterministic current: it must cover the rows once and in order, give the
same shape for the same arguments, fit the card's shared memory up to the
pass's ceiling on ng and raise above it. The wrappers return their (n,)
outputs as views of row-padded buffers (``cuda_cic.padded_rows``) on either
device; on the CPU those carry the plain versions' values.
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch.ops import cuda_cic, cuda_rng, cuda_sheath

NS = (1, 31, 1_000_000, 1_000_003)
NGS = (2, 11, 51, 1760)
SMS = (132, 114)  # H100 SXM, H100 PCIe


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
        assert shape.smem <= cuda_cic.SMEM_LIMIT
        per_sm = -(-shape.blocks // sms)
        assert per_sm * (shape.smem + cuda_sheath.BLOCK_RESERVED) <= cuda_sheath.SM_SHARED
        assert per_sm * shape.threads <= cuda_sheath.SM_THREADS


@pytest.mark.parametrize("sms", SMS)
def test_launch_shape_raises_above_the_ceiling(sms):
    with pytest.raises(ValueError, match="item 10"):
        cuda_sheath.launch_shape(1_000_000, cuda_sheath.MAX_NG + 1, sms)


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
