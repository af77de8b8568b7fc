"""The large modes of the periodic, explicit and slab kernels, on the CPU.

``cuda_cic.sweep_launch`` fixes the launch of the twelve grid-stride
kernels (the Picard pass and its shared window, both finalizes, the
gather, the leapfrog sweep and deposit, the fused Boris push, the slab
pass, both slab finalizes, the slab leapfrog push and the carried domain
cycle) from the sizes alone, and ``deposit_launch_shape(..., hists=1)``
that of the single deposit: up to each kernel's old shared-memory ceiling
the launch is the one the kernels had before the large modes (kernel,
grid, block, shared-memory bytes), above it the global mode (nothing in
shared memory, every add a global float atomic), up to
``LARGE_MAX_NG``, where they raise. ``explicit_cycle`` keeps its ceiling.
Every launch shape counts its kernel's static shared bytes, and
``cuda_cic.check_static_smem`` holds those tables to the compiler's
report. The tools that drive the main paths take ``--ng``.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pypic_tpu_torch.ops import _build, cuda_cic, cuda_sheath
from pypic_tpu_torch.tools import domain as drow
from pypic_tpu_torch.tools import headline

LIMIT = cuda_cic.SMEM_LIMIT
SMS = (132, 114)  # H100 SXM, H100 PCIe
NS = (1, 4097, 10_000_003)
# every kernel's shared memory before the large modes, as its launcher
# asked for it (csrc): (float32 arrays of ng nodes, its static bytes as
# ptxas -v reports them on sm_90a); the ceiling its wrapper checked
# counted the arrays alone (arrays 4 ng <= SMEM_LIMIT). The carried domain
# cycle kept the global field and the slab's ext_n floats.
BEFORE = {
    "picard_iteration": (2, 0), "picard_iteration_shared": (2, 16),
    "picard_finalize_nodep": (1, 0), "picard_finalize": (2, 0),
    "gather": (1, 0), "leapfrog_gather_push_deposit": (2, 0),
    "boris_gather_push": (1, 0), "picard_iteration_ext": (2, 0),
    "picard_iteration_ext shared": (2, 16), "picard_finalize_ext": (2, 256),
    "picard_finalize_ext_nodep": (1, 256), "leapfrog_gather_push": (1, 0),
    "explicit_domain_cycle": (1, 16),
}
# the slab a domain cycle deposits onto: one rank's whole grid and
# configs[4]'s carried halo of 13 cells a side
HALO = 13


def _blocks_before(n, sms):
    return max(1, min(-(-n // 256), 8 * sms))


def _extra(kernel, ng):
    return 4 * (ng + 2 * HALO + 1) if kernel == "explicit_domain_cycle" else 0


def _ceiling_before(kernel):
    arrays, _ = BEFORE[kernel]
    if kernel == "explicit_domain_cycle":  # ng + ext_n floats
        return (LIMIT // 4 - 2 * HALO - 1) // 2
    return LIMIT // (4 * arrays)


def test_the_table_names_every_kernel():
    assert set(cuda_cic.SWEEP_KERNELS) == set(BEFORE)
    assert cuda_cic.SWEEP_KERNELS == BEFORE


@pytest.mark.parametrize("kernel", sorted(BEFORE))
def test_launches_up_to_the_old_ceilings_are_unchanged(kernel):
    """Every ng from 2 to the kernel's old ceiling launches as before:
    the shared mode, the old grid and block and the old shared-memory
    bytes. The only exceptions are the last few nodes below the ceiling
    of the kernels with static shared memory, where the old launch asked
    for more than a block holds (the dynamic bytes and the static ones
    above SMEM_LIMIT, which the card refuses): there the global mode
    runs."""
    arrays, static = BEFORE[kernel]
    top = _ceiling_before(kernel)
    refused = 0
    for ng in range(2, top + 1):
        extra = _extra(kernel, ng)
        old = 4 * arrays * ng + extra
        got = cuda_cic.sweep_launch(kernel, 1_000_003, ng, 132, extra)
        if old + static <= LIMIT:
            assert (got.mode, got.smem) == ("shared", old), ng
        else:
            refused += 1
            assert (got.mode, got.smem) == ("global", 0), ng
    # 16 static bytes cost two nodes of two arrays, 256 bytes 32 of two
    # and 64 of one
    assert refused == {0: 0, 16: 2, 256: 64 // arrays}[static]
    for n in NS:
        for sms in SMS:
            got = cuda_cic.sweep_launch(kernel, n, 200, sms, _extra(kernel, 200))
            assert (got.blocks, got.threads) == (_blocks_before(n, sms), 256)


@pytest.mark.parametrize("kernel", sorted(BEFORE))
def test_large_modes_above_the_ceilings(kernel):
    """Above the old ceiling: the global mode on the old grid, no shared
    memory asked for; the raise only above LARGE_MAX_NG, naming it. Rows 1
    and 2 launch through cuda_cic.cluster_launch, in the mode its
    PASS_RULE names there: the cluster mode (whole clusters of 1,024
    threads, a slice of shared memory a CTA), or on the old grid with no
    shared memory the pair mode or the global one."""
    top = _ceiling_before(kernel)
    samples = sorted({top + 1, top + 2, 32_768, 57_856, 57_857, 65_536,
                      1 << 20, cuda_cic.LARGE_MAX_NG})
    for ng in samples:
        if ng <= top:
            continue
        want = "global"
        if kernel in cuda_cic.CLUSTER_KERNELS:
            want = cuda_cic.pass_mode(kernel, 10_000_000, ng)
            got = cuda_cic.cluster_launch(kernel, 10_000_000, ng, 132)
            if want == "cluster":
                c = cuda_cic.cluster_size(kernel, ng)
                assert (got.mode, got.cluster, got.threads) == ("cluster", c, 1024), ng
                assert got.blocks % c == 0 and got.smem == 4 * -(-ng // c)
                continue
            assert want in ("global", "pair")
        else:
            got = cuda_cic.sweep_launch(kernel, 10_000_000, ng, 132, _extra(kernel, ng))
        assert (got.blocks, got.threads) == (_blocks_before(10_000_000, 132), 256)
        assert (got.mode, got.smem) == (want, 0), ng
    big = cuda_cic.LARGE_MAX_NG
    with pytest.raises(ValueError, match="LARGE_MAX_NG") as err:
        cuda_cic.sweep_launch(kernel, 1000, big + 1, 132, _extra(kernel, big + 1))
    assert kernel.split()[0] in str(err.value)


def test_single_deposit_launches_are_unchanged_up_to_58112():
    """``deposit`` (one histogram): below its ceiling the shape is the one
    it was, for every ng at the configs' row counts and a sample of the
    rest (the rule copied from the launch shape before the large mode);
    above it cols 0 and no shared memory; the raise above LARGE_MAX_NG."""
    def before(n, ng, sms, max_cols):
        if n >= 4 * 1024 * sms:
            cols = max_cols
            while 4 * cols * ng > LIMIT:
                cols //= 2
            return (4, sms, 1024, cols, 4 * cols * ng)
        return (1, max(1, min(-(-n // 256), 8 * sms)), 256, 1, 4 * ng)

    top = LIMIT // 4
    for ng in range(2, top + 1):
        for n, max_cols in ((999_996, 32), (100_007_936, 32), (999_996, 1)):
            s = cuda_cic.deposit_launch_shape(n, ng, False, 132, hists=1,
                                              max_cols=max_cols)
            assert (s.rows, s.blocks, s.threads, s.cols, s.smem) == before(
                n, ng, 132, max_cols), (n, ng)
            assert s.mode == "shared"
    for ng in (2, 200, 227, 3200, 29_057, top):
        for n in NS + (50_000,):
            for sms in SMS:
                s = cuda_cic.deposit_launch_shape(n, ng, False, sms, hists=1)
                assert (s.rows, s.blocks, s.threads, s.cols, s.smem) == before(
                    n, ng, sms, 32)
    for ng in (top + 1, 65_536, 1 << 20, cuda_cic.LARGE_MAX_NG):
        for n in NS:
            s = cuda_cic.deposit_launch_shape(n, ng, False, 132, hists=1)
            assert (s.cols, s.smem, s.mode) == (0, 0, "global")
            assert (s.rows, s.blocks, s.threads) == before(n, 200, 132, 32)[:3]
    with pytest.raises(ValueError, match="LARGE_MAX_NG"):
        cuda_cic.deposit_launch_shape(10, cuda_cic.LARGE_MAX_NG + 1, False, 132, hists=1)


def test_only_explicit_cycle_keeps_a_ceiling():
    """explicit_cycle keeps four ng-float arrays, 256 B and its ticket's
    16 static bytes a block: its check passes at 14,511 nodes and raises
    above, naming the shared memory (the card refused 14,512, whose
    dynamic bytes alone fill the block); the explicit engine calls it at
    ng <= 1,024 only."""
    from pypic_tpu_torch.engines import explicit

    cuda_cic.check_cycle_smem(14_511)
    with pytest.raises(ValueError, match="shared memory") as err:
        cuda_cic.check_cycle_smem(14_512)
    assert "item 10" not in str(err.value)
    assert explicit.ONE_KERNEL_MAX_NG == 1024


@pytest.mark.parametrize("nodes,arrays,extra,static,want", [
    (29_056, 2, 0, 0, "shared"), (29_057, 2, 0, 0, "global"),
    (29_054, 2, 0, 16, "shared"), (29_055, 2, 0, 16, "global"),
    (57_856, 2, 0, 0, "global"), (57_857, 2, 0, 0, "global"),
    (58_112, 1, 0, 0, "shared"), (58_113, 1, 0, 0, "global"),
    (29_024, 2, 0, 256, "shared"), (29_025, 2, 0, 256, "global"),
    (58_048, 1, 0, 256, "shared"), (58_049, 1, 0, 256, "global"),
    (29_040, 1, 4 * 29_067, 16, "shared"), (29_041, 1, 4 * 29_068, 16, "global"),
    (57_856, 1, 4 * 57_883, 16, "global"), (57_857, 1, 4 * 57_884, 16, "global"),
])
def test_smem_mode_is_a_function_of_the_sizes(nodes, arrays, extra, static, want):
    assert cuda_cic.smem_mode(nodes, arrays, extra, static) == want


def test_large_launches_are_counted_apart():
    """``LARGE_LAUNCHES`` counts a wrapper's launches in a large mode
    beside ``LAUNCHES``; the plain versions count nothing, and
    reset_launch_counts clears both."""
    cuda_cic.reset_launch_counts()
    cuda_cic._count("gather", "shared")
    cuda_cic._count("gather", "global")
    cuda_cic._count("boris_gather_push_deposit", "field")
    assert cuda_cic.LAUNCHES["gather"] == 2
    assert dict(cuda_cic.LARGE_LAUNCHES) == {"gather global": 1,
                                             "boris_gather_push_deposit field": 1}
    cuda_cic.reset_launch_counts()
    p = torch.rand(1000) * 65_536
    cuda_cic.gather(torch.zeros(65_536), p, periodic=True)
    assert not any(cuda_cic.LAUNCHES.values()) and not cuda_cic.LARGE_LAUNCHES


def test_tools_take_ng():
    """tools/headline.py and tools/domain.py take --ng: the headline cell
    and configs[4] (and its carriers) refine the grid at L = 22 Debye
    lengths, bench's halo from the thermal excursion in the finer cells,
    and step on the CPU at ng = 65,536."""
    from pypic_tpu_torch.parallel import domain, domain_implicit, make_mesh
    from pypic_tpu_torch.runner import run

    args = headline.parser().parse_args(["drift", "--ng", "65536", "--n", "4096"])
    assert (args.ng, args.n) == (65_536, 4096)
    assert headline.parser().parse_args(["profile", "--out", "x"]).ng == headline.NG
    cfg, step, st = headline.headline_state(4096, "cpu", ng=65_536)
    base = headline.headline_config(4096)
    assert cfg.grid.ng == 65_536 and math.isclose(cfg.grid.length, base.grid.length)
    st, m = run(step, st, 1)
    assert bool(torch.isfinite(st.p).all()) and int(m.picard_iters[0]) == 4

    args = drow.parser().parse_args(["--ng", "65536", "--n", "4096", "--explicit"])
    assert (args.ng, args.n, args.explicit) == (65_536, 4096, True)
    mesh = make_mesh(device="cpu")
    cfg, st = drow.implicit_row(mesh, 4096, ng=65_536)
    assert cfg.grid.ng == 65_536 and math.isclose(cfg.grid.length, drow.grid().length)
    # the excursion of 8 sigma a step in cells grows as the cells shrink
    _, _, _, reach, cap = drow._load(4096, mesh, 1, None, 65_536)
    assert cfg.halo == min(65_536 - 3, max(4, reach)) and reach > 100 * 13
    assert cfg.migrate_cap == cap == 4096
    st, m = run(domain_implicit.make_step(cfg, mesh), st, 1)
    assert int(m.n_dropped[0]) == 0 and bool(torch.isfinite(st.p).all())
    for over in ({}, {"carried_rho": "on"}):
        cfg, st = drow.explicit_row(mesh, 4096, ng=65_536, **over)
        assert cfg.grid.ng == 65_536
        st, m = run(domain.make_step(cfg, mesh), st, 1)
        assert int(m.n_dropped[0]) == 0
    jobs = drow.rank_run(mesh, drow.host_load(2048), [("implicit", 1, {"ng": 4096})])
    assert jobs[0]["rows"]["picard_iters"] == [4]
    assert np.isfinite(jobs[0]["p"]).all()


# the launches the card refused before the launch shapes counted static
# shared bytes (the dynamic bytes fit SMEM_LIMIT, the static ones did
# not): ng a family (n 1,000,003 wide, 10,007 narrow)
REFUSED = {
    ("deposit", 1_000_003): [], ("deposit", 10_007): [],
    ("deposit2", 1_000_003): [], ("deposit2", 10_007): [],
    ("boris_gather_push_deposit", 1_000_003): [894, 11_622, 19_370],
    ("boris_gather_push_deposit", 10_007): [19_370],
    ("sheath pass", 1_000_003): [894], ("deposit_det", 1_000_003): [908, 1816],
}


def _shape(family, n, ng):
    if family in ("sheath pass", "deposit_det"):
        return cuda_sheath.launch_shape(n, ng, 132, family == "sheath pass")
    hists, field = {"deposit": (1, False), "deposit2": (2, False),
                    "boris_gather_push_deposit": (2, True)}[family]
    return cuda_cic.deposit_launch_shape(n, ng, field, 132, hists)


@pytest.mark.parametrize("family,n", sorted(REFUSED))
def test_launch_shapes_count_static_bytes(family, n, monkeypatch):
    """The wide deposits and the sheath pass's grid (and deposit_det's):
    for every ng up to SMEM_LIMIT // 4 + 1, a launch's shared bytes and its
    kernel's static ones fit a block, and the shape is the one it was
    without the static bytes except where that one did not fit (REFUSED,
    where the card returned 'invalid argument')."""
    static = (cuda_sheath.SMALL_STATIC_BYTES if family in ("sheath pass", "deposit_det")
              else cuda_cic.DEPOSIT_STATIC[family])
    top = LIMIT // 4 + 1
    new = [_shape(family, n, ng) for ng in range(2, top + 1)]
    monkeypatch.setattr(cuda_sheath, "SMALL_STATIC_BYTES", 0)
    monkeypatch.setitem(cuda_cic.DEPOSIT_STATIC, "boris_gather_push_deposit", 0)
    refused = []
    for ng, got in zip(range(2, top + 1), new):
        large = got.large if hasattr(got, "large") else got.mode != "shared"
        assert got.smem + (cuda_cic.STATIC_SMEM_ROOM if large else static) <= LIMIT, ng
        old = _shape(family, n, ng)
        old_large = old.large if hasattr(old, "large") else old.mode != "shared"
        if old.smem + (0 if old_large else static) <= LIMIT:
            assert got == old, ng
        else:
            refused.append(ng)
    assert refused == REFUSED[(family, n)]


def _mangled(name, args):
    """A kernel's name mangled as nvcc mangles one in an anonymous
    namespace, with bool template arguments."""
    targs = "I" + "".join(f"Lb{a}E" for a in args) + "E" if args else ""
    return f"_ZN12_GLOBAL__N_1{len(name)}{name}{targs}EvPKfS1_"


def _report(counted):
    """A ptxas -v report of one instantiation a table entry, each with the
    given static bytes (none written when 0, as ptxas omits them)."""
    lines = []
    for entry, smem in counted.items():
        if entry in cuda_cic.STATIC_SMEM_KERNELS:
            name, args = cuda_cic.STATIC_SMEM_KERNELS[entry]
            targs = [args.get(i, 0) for i in range(max(args, default=-1) + 1)]
        else:
            name, targs = entry, []
        lines.append(f"ptxas info    : Compiling entry function '{_mangled(name, targs)}' "
                     "for 'sm_90a'")
        lines.append(f"ptxas info    : Function properties for {_mangled(name, targs)}")
        lines.append("ptxas info    : Used 32 registers, used 1 barriers"
                     + (f", {smem} bytes smem" if smem else "") + ", 400 bytes cmem[0]")
    return "\n".join(lines)


def test_static_smem_report_against_the_tables():
    """check_static_smem reads the compiler's report (names and template
    arguments from the mangled names, the static bytes, 0 where ptxas
    writes none): a report at the tables' own bytes passes; one byte more
    for any entry, or an entry missing, is named."""
    assert _build._kernel_of(
        "_ZN38_GLOBAL__N__b2a58af5_6_cic_cu_8a77962423picard_iteration_kernelILb0ELb1ELi2EEEvPKfS2_"
    ) == ("picard_iteration_kernel", (0, 1, 2))
    assert _build._kernel_of("_ZN12_GLOBAL__N_113det_fixed_outEPKy") == ("det_fixed_out", ())
    counted = {k: v for k, (_, v) in cuda_cic.SWEEP_KERNELS.items()}
    counted.update(cuda_cic.DEPOSIT_STATIC)
    counted.update({"sheath pass": 16, "deposit_det": 16})
    counted.update({k: cuda_cic.STATIC_SMEM_ROOM for k in cuda_cic.FIELD_SMEM_KERNELS})
    assert set(counted) == set(cuda_cic.STATIC_SMEM_KERNELS) | set(cuda_cic.FIELD_SMEM_KERNELS)
    assert cuda_cic.check_static_smem(_report(counted)) == []
    assert _build.static_smem(_report(counted))[("picard_iteration_kernel", (0, 1))] == 16
    for entry in ("picard_iteration", "boris_gather_push_deposit", "sheath_large_kernel"):
        more = dict(counted, **{entry: counted[entry] + 16})
        (bad,) = cuda_cic.check_static_smem(_report(more))
        assert bad.startswith(entry) and "static bytes" in bad
    less = {k: v for k, v in counted.items() if k != "deposit_det"}
    (bad,) = cuda_cic.check_static_smem(_report(less))
    assert "deposit_det_kernel" in bad and "no " in bad


def test_static_smem_kernels_are_in_the_sources():
    """Every kernel the tables name is a __global__ function of csrc."""
    src = "".join(p.read_text() for p in
                  (Path(cuda_cic.__file__).parent.parent / "csrc").glob("*.cu"))
    names = {k for k, _ in cuda_cic.STATIC_SMEM_KERNELS.values()}
    for name in names | set(cuda_cic.FIELD_SMEM_KERNELS):
        assert re.search(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                         + name + r"\s*\(", src), name
