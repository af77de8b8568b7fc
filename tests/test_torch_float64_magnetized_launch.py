"""The launches of the magnetized engine's double kernels (a float64 state
on the card: rows 7-9, 22 and 23), on the CPU.

A double column, field or PCR row takes twice the bytes of a float one,
so the wide deposits' lane columns halve and their large modes begin at
about half the float nodes (``deposit_launch_shape`` and ``sweep_launch``
with ``item`` 8), and the Newton large path holds a CTA of at most
``cuda_newton.LARGE_F64_THREADS`` threads. Every float32 launch stays the
one it was (the frozen values below, and ``tests/test_torch_deposit_
launch.py``). The names each wrapper forms for its double entry point and
launch count exist in the library's signatures and in ``LAUNCHES``, and
``check_f64_kernels`` finds each double template in the compiler's report.
"""

import ctypes

import numpy as np
import pytest
import torch

from pypic_tpu_torch.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN
from pypic_tpu_torch.ops import _build, cuda_cic, cuda_newton

LIMIT = cuda_cic.SMEM_LIMIT
SMS = 132
# the last node each kernel keeps in shared memory: (float32, float64)
CEILINGS = {
    # deposit2: one lane column of its two histograms
    "deposit2": (29_056, 14_528),
    # the carried Boris deposit: one column of two histograms, the field
    # and its clamp count's 16 static bytes
    "boris_gather_push_deposit": (19_369, 9_684),
}


@pytest.mark.parametrize("name", sorted(CEILINGS))
@pytest.mark.parametrize("n", [16_384, 999_996, 10_000_000])
def test_double_deposits_leave_shared_memory_at_half_the_nodes(name, n):
    """The double deposit2 and carried deposit: the float32 grid (rows,
    blocks, threads) at every ng, lane columns of 8 B halved until a block
    holds them, one column up to the double ceiling, the large mode above
    it (the carried deposit's field alone in shared memory up to 28,928
    nodes, then none); the float32 launch at the same sizes its own,
    twice as high, ceiling."""
    field = name == "boris_gather_push_deposit"
    f32_top, f64_top = CEILINGS[name]
    static = cuda_cic.DEPOSIT_STATIC[name]
    assert f64_top == (LIMIT - static) // (8 * 3 if field else 8 * 2)
    assert f32_top == (LIMIT - static) // (4 * 3 if field else 4 * 2)
    for ng in (600, 800, f64_top, f64_top + 1, 20_000, f32_top, f32_top + 1,
               28_928, 28_929, 65_536):
        got = cuda_cic.deposit_launch_shape(n, ng, field, SMS, item=8)
        f32 = cuda_cic.deposit_launch_shape(n, ng, field, SMS)
        assert (got.rows, got.blocks, got.threads) == (f32.rows, f32.blocks, f32.threads)
        if ng <= f64_top:
            assert got.mode == "shared" and got.cols >= 1, ng
            assert got.smem + static <= LIMIT
            assert got.smem == 8 * (2 * got.cols + int(field)) * ng
            # the columns halve from the float32 kernel's (or equal them)
            assert got.cols in (f32.cols, f32.cols // 2, f32.cols // 4)
        elif field and ng <= cuda_cic.field_smem_max_ng(8):
            assert (got.mode, got.cols, got.smem) == ("field", 0, 8 * ng), ng
        else:
            assert (got.mode, got.cols, got.smem) == ("global", 0, 0), ng
        if ng <= f32_top:
            assert f32.mode == "shared", ng
        else:
            assert f32.mode == ("field" if field and ng <= cuda_cic.FIELD_SMEM_MAX_NG
                                else "global"), ng


def test_double_deposit_columns_at_the_rows():
    """At the configs[3] row (999,996 rows, 600 nodes) the double deposit2
    takes 16 lane columns of its two histograms (153,600 B; 32 would take
    307,200) and the carried deposit 16 beside its field (158,400 B); the
    float32 kernels keep their 32 (frozen). At the D-N row (50,000 rows,
    800 nodes) and the carried patch (16,384, 600) both dtypes take the
    narrow grid's one column."""
    d2 = cuda_cic.deposit_launch_shape(999_996, 600, False, SMS, item=8)
    bd = cuda_cic.deposit_launch_shape(999_996, 600, True, SMS, item=8)
    assert (d2.rows, d2.blocks, d2.threads, d2.cols, d2.smem) == (4, 132, 1024, 16, 153_600)
    assert (bd.cols, bd.smem) == (16, 158_400)
    for field in (False, True):
        f32 = cuda_cic.deposit_launch_shape(999_996, 600, field, SMS)
        assert (f32.rows, f32.blocks, f32.threads, f32.cols) == (4, 132, 1024, 32)
        assert f32.smem == 4 * (2 * 32 + int(field)) * 600
    for n, ng, blocks in ((50_000, 800, 196), (16_384, 600, 64)):
        for item in (4, 8):
            s = cuda_cic.deposit_launch_shape(n, ng, False, SMS, item=item)
            assert (s.rows, s.blocks, s.threads, s.cols) == (1, blocks, 256, 1)
            assert s.smem == item * 2 * ng


def test_double_push_sweep_ceiling():
    """The double push (row 8) keeps its field in shared memory to 29,056
    nodes (float32: 58,112), the global mode above; the grid is the float
    one's."""
    for ng, mode in ((600, "shared"), (29_056, "shared"), (29_057, "global"),
                     (65_536, "global")):
        got = cuda_cic.sweep_launch("boris_gather_push", 999_996, ng, SMS, item=8)
        f32 = cuda_cic.sweep_launch("boris_gather_push", 999_996, ng, SMS)
        assert got.mode == mode and (got.blocks, got.threads) == (f32.blocks, f32.threads)
        assert got.smem == (8 * ng if mode == "shared" else 0)
        assert f32.mode == ("shared" if ng <= 58_112 else "global")


@pytest.mark.parametrize("rows,k,threads", [
    (1025, 3, 352), (2048, 4, 512), (4096, 8, 512), (16_384, 32, 512),
    (65_536, 128, 512), (262_144, 512, 512)])
def test_double_newton_large_split(rows, k, threads):
    """The double Newton large path: k = ceil(rows / 512) rows a thread,
    threads = ceil(rows / k) rounded up to a warp, at most
    LARGE_F64_THREADS = 512 (2 x 512 PCR rows of 40 B: 172,032 B of
    shared memory; 1,024 threads would need 344,064); the float32 split
    is the one it was."""
    assert cuda_newton.large_split(rows, 8) == (k, threads)
    assert threads <= cuda_newton.LARGE_F64_THREADS and k * threads >= rows
    assert cuda_newton.solve_rows(rows, 8, mode="single") == k * threads
    # the float32 path: ceil(rows / 1024) rows a thread (frozen)
    k32 = -(-rows // 1024)
    assert cuda_newton.large_split(rows)[0] == k32
    # the small path does not depend on the element
    assert cuda_newton.solve_rows(1024, 8) == cuda_newton.solve_rows(1024) == 1024
    pcr = 2 * (2 * 512 + 2 * 512) * (32 + 8) + 2 * 512 * 8
    assert pcr == 172_032 <= LIMIT < 2 * (2 * 1024 + 2 * 1024) * (32 + 8)


def test_newton_paths_name_their_double_entry_points():
    """cuda_newton._path names the double kernel's entry point and launch
    count (``_f64`` last) and gives its large path in the mode 'single' a
    float64 scratch of (4 + R) k threads elements; each name is a
    launcher of the library and a key of LAUNCHES, and the cluster mode's
    entry points (``_cluster``, ``_f64`` last) are launchers too."""
    cpu = torch.device("cpu")
    for what, rows_r in (("boltzmann_dirichlet", 5), ("boltzmann_dn", 6)):
        for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
            name, split, scratch = cuda_newton._path(what, 800, cpu, dtype)
            assert (name, split, scratch) == (what + suffix, None, None)
            name, shape, scratch = cuda_newton._path(what, 4096, cpu, dtype, mode="single")
            assert name == f"{what}_large{suffix}"
            assert (shape.k, shape.threads) == cuda_newton.large_split(
                4096, torch.finfo(dtype).bits // 8)
            assert scratch.dtype == dtype and scratch.numel() == rows_r * shape.rows
            for n in (what + suffix, f"{what}_large{suffix}"):
                assert f"pypic_{n}" in _build._SIGNATURES and n in cuda_cic.LAUNCHES
            assert f"pypic_{what}_cluster{suffix}" in _build._SIGNATURES
    with pytest.raises(ValueError, match="at most"):
        cuda_newton._path("boltzmann_dn", cuda_newton.LARGE_MAX_ROWS + 1, cpu, torch.float64)


@pytest.mark.parametrize("name", ["deposit2", "boris_gather_push",
                                  "boris_gather_push_deposit"])
def test_rows_7_to_9_launchers(name):
    """_launcher forms rows 7-9's double entry point and count; their
    signatures take every scalar as a double (c_double) where the float
    entry point takes c_float, and the same arguments otherwise."""
    class _Entries:
        def __getattr__(self, attr):
            return attr
    for dtype, suffix in ((torch.float32, ""), (torch.float64, "_f64")):
        entry, count = cuda_cic._launcher(_Entries(), name, dtype)
        assert (entry, count) == (f"pypic_{name}{suffix}", name + suffix)
        assert count in cuda_cic.LAUNCHES
    f32, _ = _build._SIGNATURES[f"pypic_{name}"]
    f64, _ = _build._SIGNATURES[f"pypic_{name}_f64"]
    assert len(f32) == len(f64)
    assert [ctypes.c_double if t is ctypes.c_float else t for t in f32] == f64


def test_newton_scalars_in_the_state_dtype():
    """newton_scalars: float32 rounds c1, dx^2, tol and step_max = 40 / c1
    to float32 once (the Pallas wrapper's), float64 keeps the Python
    float64 values JAX's XLA solve forms (step_max from the float64 c1)."""
    te, dx, tol = 116_000.0, 2e-5, 1e-9
    c1 = E_CHARGE / (K_BOLTZMANN * te)
    f64 = cuda_newton.newton_scalars(te, dx, tol, torch.float64)
    assert f64 == (c1, dx * dx, tol, 40.0 / c1)
    f32 = cuda_newton.newton_scalars(te, dx, tol)
    assert f32 == tuple(float(np.float32(x)) for x in (c1, dx * dx, tol, 40.0 / c1))
    assert cuda_newton._coef(torch.float64) == E_CHARGE / EPSILON_0
    assert cuda_newton._coef(torch.float32) == cuda_newton._COEF


def test_magnetized_double_instances_in_the_report():
    """F64_INSTANCES names the double templates of rows 7-9 (with the
    element type's index among their template arguments) and the four
    Newton kernels (the element type alone); check_f64_kernels finds a
    double instantiation of each in a ptxas report and names the missing
    ones."""
    ours = {"deposit2_kernel": 3, "deposit2_global_kernel": 3, "boris_kernel": 2,
            "boris_deposit_kernel": 3, "boris_deposit_global_kernel": 4,
            "newton_dd_kernel": 0, "newton_dn_kernel": 0, "newton_dd_large_kernel": 0,
            "newton_dn_large_kernel": 0}
    instances = dict(cuda_cic.F64_INSTANCES)
    assert {k: instances[k] for k in ours} == ours

    def entry(name, args):
        targs = "".join(f"Li{a}E" if isinstance(a, int) else a for a in args)
        return (f"ptxas info    : Compiling entry function "
                f"'_ZN12_GLOBAL__N_1{len(name)}{name}I{targs}EEvPKT_' for 'sm_90a'\n"
                "ptxas info    : Used 64 registers, used 1 barriers, 512 bytes smem")
    log = "\n".join(entry(k, [1] * i + ["d"]) for k, i in ours.items())
    missing = cuda_cic.check_f64_kernels(log)
    assert not any(k in m for m in missing for k in ours)
    assert len(missing) == len(cuda_cic.F64_INSTANCES) - len(ours)
    assert _build._kernel_of(
        "_ZN12_GLOBAL__N_116newton_dd_kernelIdEEvPKT_S3_S3_PS1_PiS4_iS1_S1_S1_S1_S1_iS1_S1_"
    ) == ("newton_dd_kernel", ("d",))
