"""The card's bookkeeping for the sheath engine's double kernels, on the
CPU: their launch shapes and scratch (``cuda_sheath.launch_shape`` with
``item=8``), the two-word sums' plain twin (``cuda_cic.fixed2_sum_plain``,
which the card's large mode equals bit for bit) and the ctypes signatures
of the ``_f64`` launchers. The float32 shapes stand as a frozen table:
the double kernels' shapes leave them as they are.
"""

import math

import numpy as np
import pytest
import torch

from pypic_tpu_torch.ops import _build, cuda_cic, cuda_sheath

LIMIT = cuda_cic.SMEM_LIMIT
STATIC = cuda_sheath.SMALL_STATIC_BYTES

# (n, ng, field): (blocks, threads, rows_per_block, smem, large, scratch)
# of the float32 launch
F32_SHAPES = {
    (1_000_000, 51, True): (264, 512, 3788, 104652, False, 53860),
    (1_000_000, 128, True): (264, 128, 3788, 66048, False, 135172),
    (1_000_003, 880, True): (132, 64, 7576, 228800, False, 464644),
    (1_000_000, 881, True): (132, 64, 7576, 229060, False, 465172),
    (4097, 907, True): (33, 32, 128, 119724, False, 119728),
    (4097, 908, True): (33, 32, 128, 119856, False, 119860),
    (1_000_000, 1760, True): (132, 32, 7576, 232320, False, 929284),
    (1_000_000, 1761, True): (264, 512, 3788, 7044, True, 15144),
    (10_000_000, 8192, True): (264, 512, 37880, 32768, True, 66592),
    (10_000_000, 65_536, True): (264, 512, 37880, 0, True, 525344),
    (10_000_000, 1 << 20, True): (264, 512, 37880, 0, True, 8389664),
    (1_000_000, 51, False): (264, 512, 3788, 104448, False, 53860),
    (1_000_000, 128, False): (264, 128, 3788, 65536, False, 135172),
    (4097, 907, False): (17, 64, 244, 232192, False, 61680),
    (4097, 908, False): (33, 32, 128, 116224, False, 119860),
    (1_000_000, 1815, False): (132, 32, 7576, 232320, False, 958324),
    (1_000_000, 1816, False): (264, 512, 3788, 0, True, 15584),
    (10_000_000, 65_536, False): (264, 512, 37880, 0, True, 525344),
}


@pytest.mark.parametrize("key", sorted(F32_SHAPES), ids=lambda k: f"{k[0]}-{k[1]}-{k[2]}")
def test_float32_sheath_shapes_are_frozen(key):
    n, ng, field = key
    got = cuda_sheath.launch_shape(n, ng, 132, field=field)
    assert (got.blocks, got.threads, got.rows_per_block, got.smem, got.large,
            got.scratch) == F32_SHAPES[key]
    assert cuda_sheath.launch_shape(n, ng, 132, field=field, item=4) == got


@pytest.mark.parametrize("field", [True, False], ids=["pass", "deposit_det"])
def test_double_ceilings_follow_from_the_block(field):
    """The double small mode holds its columns of ng doubles (and the
    pass's field) beside the static bytes: 880 nodes for the pass, 907 for
    deposit_det, half the float32 ceilings (1,760, 1,815) rounded down;
    above it the large mode, its field in shared memory to 28,928 nodes."""
    top = (LIMIT - STATIC) // (8 * (cuda_sheath.MIN_THREADS + int(field)))
    assert top == (880 if field else 907)
    assert cuda_sheath.MAX_NG_F64 == 880 and cuda_sheath.MAX_NG == 1760
    assert cuda_sheath.field_smem_max_ng(8) == 28_928
    assert cuda_sheath.field_smem_max_ng() == cuda_cic.FIELD_SMEM_MAX_NG == 57_856
    for ng in (2, 51, 128, top - 1, top):
        got = cuda_sheath.launch_shape(1_000_000, ng, 132, field=field, item=8)
        assert not got.large
        assert got.smem == 8 * (got.threads + int(field)) * ng
        assert got.smem + STATIC <= LIMIT
        assert got.scratch == 8 * got.blocks * ng + 4
    for ng in (top + 1, 8192, 28_928, 28_929, 65_536, cuda_cic.LARGE_MAX_NG):
        got = cuda_sheath.launch_shape(10_000_000, ng, 132, field=field, item=8)
        assert got.large and got.threads == cuda_sheath.LARGE_THREADS
        assert got.smem == (8 * ng if field and ng <= 28_928 else 0)
        assert got.scratch == 8 * got.blocks + 16 * ng
    with pytest.raises(ValueError, match="LARGE_MAX_NG"):
        cuda_sheath.launch_shape(1000, cuda_cic.LARGE_MAX_NG + 1, 132, field=field, item=8)
    with pytest.raises(ValueError, match="item"):
        cuda_sheath.launch_shape(1000, 51, 132, field=field, item=2)


def test_double_grid_at_the_configs2_shape():
    """At n = 1e6, ng 51 the double pass runs 256-thread blocks, two an SM
    (its 257 columns of 51 doubles), and the same persistent partition of
    rows as the float32 launch's rule gives; the large scratch holds two
    int64 words a node."""
    got = cuda_sheath.launch_shape(1_000_000, 51, 132, item=8)
    assert (got.blocks, got.threads, got.large) == (264, 256, False)
    assert got.blocks * got.rows_per_block >= 1_000_000
    maxima, words = cuda_cic.large_scratch("cpu", 264, 8192, torch.float64)
    assert maxima.dtype == torch.float64 and maxima.shape == (264,)
    assert words.dtype == torch.int64 and words.shape == (2 * 8192,)
    maxima, words = cuda_cic.large_scratch("cpu", 264, 8192)
    assert maxima.dtype == torch.float32 and words.shape == (8192,)


@pytest.mark.parametrize("n", [1, 1000, 1_000_000, 10_000_000, 100_000_000])
def test_fraction_bits(n):
    """L = min(44, 62 - ceil(log2 2n)): 2n words of at most 2^(L-1) stay
    below 2^62, and the conversion's integer below 2^53."""
    bits = cuda_cic.fixed2_bits(n)
    assert bits == min(44, 62 - math.ceil(math.log2(2 * n)))
    assert 2 * n * 2 ** (bits - 1) <= 2 ** 62
    assert 2 ** 8 * 2 ** bits + 2 ** bits < 2 ** 53


def _terms(n, ng, seed, scale=1e3):
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.uniform(0.0, ng - 1.0, n))
    v = torch.from_numpy(rng.normal(size=n) * scale * np.where(
        rng.uniform(size=n) < 0.1, 1e-9, 1.0))
    return cuda_cic.deposit_terms_plain(p, v, ng, periodic=False)


@pytest.mark.parametrize("n, ng", [(7, 3), (1000, 51), (50_000, 881), (200_000, 40_000)])
def test_two_word_twin_against_fsum(n, ng):
    """The twin's node sums against math.fsum of each node's terms: within
    2 float64 ulps plus n 2^-(k+L+1) (measured: exact, the correctly
    rounded sum); their bits the same in any order of the rows."""
    nodes, terms = _terms(n, ng, seed=ng)
    got = cuda_cic.fixed2_sum_plain(nodes, terms, ng, n)
    assert got.dtype == torch.float64
    m = float(terms.abs().max())
    k = 62 - math.frexp(2.0 * n * m)[1]
    quantum = n * 2.0 ** -(k + cuda_cic.fixed2_bits(n) + 1)
    nn, tt = nodes.numpy(), terms.numpy()
    order = np.argsort(nn, kind="stable")
    starts = np.searchsorted(nn[order], np.arange(ng + 1))
    exact = np.array([math.fsum(tt[order[starts[j]:starts[j + 1]]]) for j in range(ng)])
    limit = 2.0 * np.spacing(np.abs(exact)) + quantum
    assert np.all(np.abs(got.numpy() - exact) <= limit)
    assert np.array_equal(got.numpy(), exact)  # correctly rounded, here
    for seed in (1, 2):
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(2 * n))
        assert torch.equal(cuda_cic.fixed2_sum_plain(nodes[perm], terms[perm], ng, n), got)


def test_two_word_twin_edges():
    """All-zero terms sum to +0; a non-finite term makes every node NaN;
    the negative low words carry into hi (sums of many small negative
    terms beside one large one)."""
    nodes = torch.tensor([0, 1, 1, 1, 2], dtype=torch.int64)
    zero = cuda_cic.fixed2_sum_plain(nodes, torch.zeros(5, dtype=torch.float64), 3, 5)
    assert torch.equal(zero, torch.zeros(3, dtype=torch.float64))
    bad = torch.tensor([1.0, float("inf"), 2.0, 3.0, 4.0], dtype=torch.float64)
    assert bool(torch.isnan(cuda_cic.fixed2_sum_plain(nodes, bad, 3, 5)).all())
    terms = torch.tensor([1e6] + [-1e-7 - 3e-23 * i for i in range(999)],
                         dtype=torch.float64)
    nodes = torch.zeros(1000, dtype=torch.int64)
    got = cuda_cic.fixed2_sum_plain(nodes, terms, 1, 1000)
    assert float(got[0]) == math.fsum(terms.tolist())


_F64_LAUNCHERS = {
    # launcher: (its float twin, the indices of its scalars)
    "pypic_sheath_picard_f64": ("pypic_sheath_picard", range(14, 18)),
    "pypic_sheath_finalize_f64": ("pypic_sheath_finalize", range(15, 19)),
    "pypic_sheath_picard_large_f64": ("pypic_sheath_picard_large", range(14, 18)),
    "pypic_sheath_finalize_large_f64": ("pypic_sheath_finalize_large", range(15, 19)),
    "pypic_hash_batch_f64": ("pypic_hash_batch", range(5, 6)),
    "pypic_deposit_det_f64": ("pypic_deposit_det", range(0)),
    "pypic_deposit_det_large_f64": ("pypic_deposit_det_large", range(0)),
    "pypic_sheath_reinject_f64": ("pypic_sheath_reinject", range(0)),
}


@pytest.mark.parametrize("name", sorted(_F64_LAUNCHERS))
def test_double_launchers_take_double_scalars(name):
    """Each ``_f64`` launcher has the float launcher's arguments with its
    state scalars as c_double (_D): a double through a c_float slot would
    round to float32 on the way. The re-injection keeps its float32
    scalars (its draws are the float kernel's)."""
    twin, scalars = _F64_LAUNCHERS[name]
    args, ret = _build._SIGNATURES[name]
    fargs, fret = _build._SIGNATURES[twin]
    assert ret == fret and len(args) == len(fargs)
    for i, (a, f) in enumerate(zip(args, fargs)):
        if i in scalars:
            assert (a, f) == (_build._D, _build._F), (name, i)
        else:
            assert a == f, (name, i)


class _Entries:
    """A stand-in library whose every entry point is its own name."""

    def __getattr__(self, name):
        return name


@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrapper", ["sheath_picard", "sheath_finalize", "deposit_det"])
def test_one_dtype_dispatch_names_each_entry_point(wrapper, dtype, large):
    """``cuda_cic._launcher`` picks the sheath pass's, finalize's and
    deposit_det's entry point from the dtype and the mode, and the count
    from the dtype alone: every name it forms is a launcher of the
    library (``_SIGNATURES``)."""
    entry, count = cuda_cic._launcher(_Entries(), wrapper, dtype, large)
    f64 = dtype == torch.float64
    assert entry == f"pypic_{wrapper}" + ("_large" if large else "") + ("_f64" if f64 else "")
    assert count == wrapper + ("_f64" if f64 else "")
    assert entry in _build._SIGNATURES and count in cuda_cic.LAUNCHES


def test_double_kernels_are_counted_and_reported():
    """The sheath slice's wrappers count their double launches under
    ``<name>_f64``; check_f64_kernels looks for their templates' double
    instantiations in the compiler's report."""
    for name in ("sheath_picard", "sheath_finalize", "deposit_det", "sheath_reinject",
                 "hash_batch"):
        assert name in cuda_cic.F64_KERNELS
        assert cuda_cic.LAUNCHES[f"{name}_f64"] == 0
    kernels = {k for k, _ in cuda_cic.F64_INSTANCES}
    assert {"sheath_pass_kernel", "sheath_large_kernel", "deposit_det_kernel",
            "deposit_det_large_kernel", "sheath_reinject_kernel",
            "hash_batch_kernel"} <= kernels
    missing = cuda_cic.check_f64_kernels("")
    assert len(missing) == len(cuda_cic.F64_INSTANCES)
    # the magnetized and explicit engines have their double kernels too
    # (items 19b, 19c): no engine refuses a float64 state on the card
    assert not hasattr(cuda_cic, "F64_ENGINE_ITEMS")
    for engine in ("explicit", "magnetized"):
        cuda_cic.check_engine_dtype(engine, torch.device("cuda", 0), torch.float64)
