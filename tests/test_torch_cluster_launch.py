"""The launch of the kernels with cluster and pair modes,
``cuda_cic.cluster_launch``, on the CPU.

Rows 1 and 2 (the Picard pass and its shared window), row 17 (the slab's
pass, both windows, float32 alone) and row 14 (the leapfrog deposit) pick
their mode from the sizes alone (``pass_mode``): ``sweep_launch``'s
shared or global mode below ``PASS_RULE``'s first node, then the rule's
modes, the cluster mode only on CLUSTER_MIN_ROWS_PER_NODE rows a node or
more. In the cluster mode C, the CTAs of a thread-block cluster, is the
least power of two up to CLUSTER_MAX whose slices of ceil(ng / C)
elements fit a CTA beside the kernel's static bytes, in each element
size the kernel takes; the grid is a whole number of clusters, at most
the clusters the card holds at once, of CLUSTER_THREADS threads. The
pair mode (float32 alone) takes the global mode's grid. The other
grid-stride kernels launch as they did.
"""

import ctypes

import pytest
import torch

from pypic_tpu_torch.ops import _build, cuda_cic

LIMIT = cuda_cic.SMEM_LIMIT
ROWS = cuda_cic.CLUSTER_KERNELS
ITEMS = [4, 8]
# each kernel with each element size it takes (row 17: float32 alone)
ROW_ITEMS = [(kernel, item) for kernel in ROWS for item in ITEMS
             if item in cuda_cic.PASS_RULE[kernel]]
# the kernels that took these modes first; rows 14 and 17 took
# sweep_launch's rule before them
PASS_ROWS = ("picard_iteration", "picard_iteration_shared")
SAMPLE_NGS = sorted({2, 200, 16_383, 16_384, 28_672, 29_056, 29_057, 32_768, 58_112,
                     58_113, 65_536, 100_003, 116_224, 116_225, 232_448, 262_144,
                     464_896, 464_897, 929_792, 929_793, 1 << 20,
                     *range(3, cuda_cic.LARGE_MAX_NG, 99_991)})


@pytest.mark.parametrize("kernel, item", ROW_ITEMS)
def test_cluster_size_is_the_least_power_of_two_that_fits(kernel, item):
    static = cuda_cic.SWEEP_KERNELS[kernel][1]
    for ng in SAMPLE_NGS:
        c = cuda_cic.cluster_size(kernel, ng, item)
        if c is None:
            assert item * -(-ng // cuda_cic.CLUSTER_MAX) + static > LIMIT, ng
            continue
        assert c & (c - 1) == 0 and 1 <= c <= cuda_cic.CLUSTER_MAX
        assert item * -(-ng // c) + static <= LIMIT, ng
        assert c == 1 or item * -(-ng // (c // 2)) + static > LIMIT, ng


@pytest.mark.parametrize("item, sizes", [
    (4, {116_224: 2, 116_225: 4, 232_448: 4, 232_449: 8, 464_896: 8, 464_897: 16,
         929_792: 16}),
    (8, {58_112: 2, 58_113: 4, 116_224: 4, 116_225: 8, 232_448: 8, 232_449: 16,
         464_896: 16})])
def test_cluster_sizes_of_the_separate_pass(item, sizes):
    """Row 1 (no static bytes): C = 2 up to 116,224 float32 nodes, 4 up to
    232,448, 8 up to 464,896, 16 up to 929,792; half of each in double."""
    for ng, c in sizes.items():
        assert cuda_cic.cluster_size("picard_iteration", ng, item) == c, ng
    top = max(sizes)
    assert cuda_cic.cluster_nodes("picard_iteration", item) == top
    assert cuda_cic.cluster_size("picard_iteration", top + 1, item) is None


def test_the_shared_window_counts_its_clamp_word():
    """Row 2's 16 static bytes take four float nodes from each slice."""
    assert cuda_cic.cluster_nodes("picard_iteration_shared", 4) == 16 * 58_108
    assert cuda_cic.cluster_nodes("picard_iteration_shared", 8) == 16 * 29_054
    assert cuda_cic.cluster_size("picard_iteration_shared", 116_216) == 2
    assert cuda_cic.cluster_size("picard_iteration_shared", 116_217) == 4


@pytest.mark.parametrize("kernel, static", [
    ("picard_iteration_ext", 0), ("picard_iteration_ext shared", 16),
    ("leapfrog_gather_push_deposit", 0)])
def test_rows_14_and_17_count_their_static_bytes(kernel, static):
    """Row 17's shared window keeps its clamp word (16 static bytes, Fault
    5's lesson) beside its slice: one CTA holds 58,108 float nodes there,
    58,112 in the separate window and in row 14, whose doubles take half."""
    one = (LIMIT - static) // 4
    assert cuda_cic.SWEEP_KERNELS[kernel][1] == static
    assert cuda_cic.cluster_size(kernel, one) == 1
    assert cuda_cic.cluster_size(kernel, one + 1) == 2
    assert cuda_cic.cluster_nodes(kernel, 4) == 16 * one
    if kernel == "leapfrog_gather_push_deposit":
        assert cuda_cic.cluster_size(kernel, 29_056, 8) == 1
        assert cuda_cic.cluster_size(kernel, 29_057, 8) == 2
        assert cuda_cic.cluster_size(kernel, 32_768, 8) == 2


def test_row_17_takes_float32_alone():
    """The slab engines run in float32 (cuda_cic.F64_ITEMS): row 17's rule
    has no double entry, and asking for one raises."""
    for kernel in ("picard_iteration_ext", "picard_iteration_ext shared"):
        assert set(cuda_cic.PASS_RULE[kernel]) == {4}
        with pytest.raises(ValueError, match="float32 alone"):
            cuda_cic.pass_mode(kernel, 10_000_000, 65_536, 8)
        with pytest.raises(ValueError, match="float32 alone"):
            cuda_cic.cluster_launch(kernel, 100, 65_536, 132, 8)


@pytest.mark.parametrize("n", [1, 4097, 10_000_000, 100_007_936])
@pytest.mark.parametrize("kernel, item", ROW_ITEMS)
def test_the_grid_is_whole_clusters_of_1024_threads(kernel, item, n):
    for ng in (65_536, 262_144, 600_000 if item == 4 else 400_000):
        for held in (None, 1, 7, 66):
            s = cuda_cic.cluster_launch(kernel, n, ng, 132, item, held, mode="cluster")
            c = cuda_cic.cluster_size(kernel, ng, item)
            clusters = 132 // c if held is None else held
            assert (s.mode, s.cluster, s.threads) == ("cluster", c, cuda_cic.CLUSTER_THREADS)
            assert s.blocks % c == 0 and 1 <= s.blocks // c <= clusters
            assert s.blocks // c == max(1, min(clusters, -(-n // (c * 1024))))
            assert s.smem == item * -(-ng // c)
            assert s.smem + cuda_cic.SWEEP_KERNELS[kernel][1] <= LIMIT


@pytest.mark.parametrize("kernel, item", ROW_ITEMS)
def test_mode_boundaries_match_the_docstring(kernel, item):
    """Below PASS_RULE's first node sweep_launch's mode; from each entry's
    first node its mode, on the grid of that mode (a cluster holds every
    ng of the cluster mode's range); the docstring names every entry's
    first node."""
    rule = cuda_cic.PASS_RULE[kernel][item]
    edges = [first + d for first, _ in rule for d in (-1, 0)]
    for first, _ in rule:
        assert f"{first:,}" in cuda_cic.cluster_launch.__doc__
    for ng in SAMPLE_NGS + edges:
        got = cuda_cic.cluster_launch(kernel, 10_000_000, ng, 132, item)
        sweep = cuda_cic.sweep_launch(kernel, 10_000_000, ng, 132, item=item)
        want = sweep.mode
        for first, mode in rule:
            if ng >= first:
                want = mode
        assert got.mode == want == cuda_cic.pass_mode(kernel, 10_000_000, ng, item), ng
        if want == "cluster":
            assert got.threads == 1024 and got.smem == item * -(-ng // got.cluster)
        else:
            assert (got.cluster, got.blocks, got.threads) == (1, sweep.blocks, 256), ng
            assert got.smem == (sweep.smem if want == "shared" else 0)


@pytest.mark.parametrize("kernel, item", ROW_ITEMS)
def test_few_rows_a_node_leave_the_cluster_mode(kernel, item):
    """Every kernel of CLUSTER_KERNELS below CLUSTER_MIN_ROWS_PER_NODE rows
    a node (one floor by element size), where the cluster mode's flush
    outweighs its sweep: the pair mode in float32, the global mode in
    float64, on the global mode's grid; at the floor the cluster mode."""
    assert cuda_cic.CLUSTER_MIN_ROWS_PER_NODE == {4: 64, 8: 48}
    ngs = [ng for ng in (16_384, 32_768, 40_000, 57_000)
           if cuda_cic.pass_mode(kernel, 10**9, ng, item) == "cluster"]
    assert len(ngs) >= 2
    for ng in ngs:
        floor = cuda_cic.CLUSTER_MIN_ROWS_PER_NODE[item] * ng
        assert cuda_cic.cluster_launch(kernel, floor, ng, 132, item).mode == "cluster"
        assert cuda_cic.pass_mode(kernel, floor, ng, item) == "cluster"
        got = cuda_cic.cluster_launch(kernel, floor - 1, ng, 132, item)
        sweep = cuda_cic.sweep_launch(kernel, floor - 1, ng, 132, item=item)
        assert got.mode == cuda_cic.pass_mode(kernel, floor - 1, ng, item) == (
            "pair" if item == 4 else "global")
        assert (got.cluster, got.blocks, got.threads, got.smem) == (1, sweep.blocks, 256, 0)
    assert cuda_cic.cluster_launch(kernel, 1000, 32_768, 132, item).mode != "cluster"


def test_the_pair_mode_takes_float32_alone():
    for kernel in ROWS:
        with pytest.raises(ValueError, match="float32 alone"):
            cuda_cic.cluster_launch(kernel, 100, 65_536, 132, 8, mode="pair")
        got = cuda_cic.cluster_launch(kernel, 10_000_000, 65_536, 132, 4, mode="pair")
        assert (got.mode, got.cluster, got.smem) == ("pair", 1, 0)
        assert all(mode != "pair" for _, mode in cuda_cic.PASS_RULE[kernel].get(8, ()))


@pytest.mark.parametrize("kernel", sorted(set(cuda_cic.SWEEP_KERNELS) - set(PASS_ROWS)))
def test_the_other_sweeps_launch_as_before(kernel):
    """Rows 3-23's grid-stride kernels keep sweep_launch's rule: the shared
    mode where their arrays and static bytes fit a block, else the global
    one, up to 8 blocks of 256 threads an SM. Rows 14 and 17 take it below
    their PASS_RULE's first node (their cluster_launch rule above it)."""
    arrays, static = cuda_cic.SWEEP_KERNELS[kernel]
    for item in ITEMS:
        for ng in (200, 16_384, 28_672, 65_536, 1 << 20):
            for n in (4097, 10_000_000):
                got = cuda_cic.sweep_launch(kernel, n, ng, 132, item=item)
                shared = item * arrays * ng + static <= LIMIT
                assert got.mode == ("shared" if shared else "global")
                assert got.smem == (item * arrays * ng if shared else 0)
                assert (got.blocks, got.threads) == (min(-(-n // 256), 8 * 132), 256)
                rule = cuda_cic.PASS_RULE.get(kernel, {}).get(item)
                if rule and ng < rule[0][0]:
                    assert cuda_cic.pass_mode(kernel, n, ng, item) == got.mode
    assert (kernel in cuda_cic.CLUSTER_KERNELS) == (kernel in (
        "picard_iteration_ext", "picard_iteration_ext shared",
        "leapfrog_gather_push_deposit"))


@pytest.mark.parametrize("kernel", ROWS)
def test_forced_modes_raise_where_they_cannot_launch(kernel):
    with pytest.raises(ValueError, match="shared mode's ceiling"):
        cuda_cic.cluster_launch(kernel, 100, 65_536, 132, mode="shared")
    with pytest.raises(ValueError, match="cluster mode's"):
        cuda_cic.cluster_launch(kernel, 100, 1 << 20, 132, mode="cluster")
    with pytest.raises(ValueError, match="LARGE_MAX_NG"):
        cuda_cic.cluster_launch(kernel, 100, cuda_cic.LARGE_MAX_NG + 1, 132)
    with pytest.raises(RuntimeError, match="no cluster"):
        cuda_cic.cluster_launch(kernel, 100, 65_536, 132, clusters=0, mode="cluster")
    assert cuda_cic.cluster_launch(kernel, 100, 200, 132, mode="global").smem == 0


@pytest.mark.parametrize("emit_v", [False, True])
@pytest.mark.parametrize("kernel", ROWS)
def test_the_wrappers_launch_on_the_card_held_clusters(monkeypatch, kernel, emit_v):
    """``_pass_launch`` sizes the grid by the clusters the card holds
    (queried once per shape) and leaves the other modes to
    cluster_launch: at 40,000 nodes C = 2 in double, 1 in float32 (row
    17)."""
    asked = []

    def held(index, kernel_, item, emit_v_, nodes, cluster):
        asked.append((kernel_, item, emit_v_, nodes, cluster))
        return 60

    monkeypatch.setattr(cuda_cic, "_sm_count", lambda index: 132)
    monkeypatch.setattr(cuda_cic, "_max_clusters", held)
    dev = torch.device("cuda", 0)
    item = max(cuda_cic.PASS_RULE[kernel])
    c = 2 if item == 8 else 1
    got = cuda_cic._pass_launch(dev, kernel, 100_007_936, 40_000, item, emit_v)
    assert got == cuda_cic.ClusterLaunch("cluster", c, 60 * c, 1024, 160_000)
    assert asked == [(kernel, item, emit_v, 40_000, c)]
    assert cuda_cic._pass_launch(dev, kernel, 100, 200, 4, emit_v).mode == "shared"
    assert cuda_cic._pass_launch(dev, kernel, 100, 65_536, item, emit_v,
                                 mode="global").mode == "global"
    assert len(asked) == 1


class _Occupancy:
    """A stand-in library: each occupancy query records its entry point and
    arguments and reports 9 clusters."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def query(*args):
            self.calls.append((name, args[:-1]))
            args[-1]._obj.value = 9
            return 0
        return query


@pytest.mark.parametrize("kernel, item, entry, args", [
    ("picard_iteration", 8, "pypic_picard_iteration_clusters", (0, 1, 1, 40_000, 2, 1024)),
    ("picard_iteration_shared", 4, "pypic_picard_iteration_clusters",
     (1, 1, 0, 40_000, 2, 1024)),
    ("picard_iteration_ext", 4, "pypic_picard_iteration_ext_clusters",
     (0, 1, 40_000, 2, 1024)),
    ("picard_iteration_ext shared", 4, "pypic_picard_iteration_ext_clusters",
     (1, 1, 40_000, 2, 1024)),
    ("leapfrog_gather_push_deposit", 8, "pypic_leapfrog_deposit_clusters",
     (1, 40_000, 2, 1024)),
    ("leapfrog_gather_push_deposit", 4, "pypic_leapfrog_deposit_clusters",
     (0, 40_000, 2, 1024))])
def test_each_kernel_asks_its_own_occupancy(monkeypatch, kernel, item, entry, args):
    """``_max_clusters`` asks the kernel's own cluster instantiation
    (cudaOccupancyMaxActiveClusters through its entry point)."""
    import contextlib

    lib = _Occupancy()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    got = cuda_cic._max_clusters.__wrapped__(0, kernel, item, True, 40_000, 2)
    assert got == 9 and lib.calls == [(entry, args)]
    assert entry in _build._SIGNATURES


@pytest.mark.parametrize("entry, before", [
    ("pypic_picard_iteration", 18), ("pypic_picard_iteration_f64", 18),
    ("pypic_picard_iteration_shared", 23), ("pypic_picard_iteration_shared_f64", 23),
    ("pypic_picard_iteration_ext", 26), ("pypic_leapfrog_deposit", 16),
    ("pypic_leapfrog_deposit_f64", 16)])
def test_the_pass_entry_points_take_the_cluster_size(entry, before):
    """The launchers take mode, blocks, threads and the CTAs a cluster
    before the stream, all ints."""
    args, res = _build._SIGNATURES[entry]
    assert len(args) == before + 1 and res is ctypes.c_int
    assert args[-5:] == [ctypes.c_int] * 4 + [ctypes.c_void_p]
    assert (cuda_cic.SMEM_MODES["cluster"], cuda_cic.SMEM_MODES["pair"]) == (2, 3)


def test_cluster_launches_are_counted_by_mode():
    cuda_cic.reset_launch_counts()
    cuda_cic._count("picard_iteration", "cluster")
    cuda_cic._count("picard_iteration_shared_f64", "cluster")
    cuda_cic._count("picard_iteration_ext", "pair")
    cuda_cic._count("picard_iteration_ext", "cluster")
    cuda_cic._count("leapfrog_gather_push_deposit_f64", "cluster")
    cuda_cic._count("leapfrog_gather_push_deposit", "shared")
    assert dict(cuda_cic.LARGE_LAUNCHES) == {
        "picard_iteration cluster": 1, "picard_iteration_shared_f64 cluster": 1,
        "picard_iteration_ext pair": 1, "picard_iteration_ext cluster": 1,
        "leapfrog_gather_push_deposit_f64 cluster": 1}
    assert cuda_cic.LAUNCHES["picard_iteration_ext"] == 2
    assert cuda_cic.LAUNCHES["leapfrog_gather_push_deposit"] == 1
    cuda_cic.reset_launch_counts()
