"""CUDA particle kernels of the ported paths and their plain versions.

The counterparts of the ``pypic_tpu/ops/pallas_cic.py`` kernels the
implicit headline step and the explicit engine reach:

* ``picard_iteration``      — ``picard_iteration_pallas`` (one Picard pass:
  gather, CN push, wrapped midpoint, half-step current deposit);
* ``picard_finalize_nodep`` — ``picard_finalize_nodep_pallas`` (the
  converged finalize sweep, no deposit);
* ``deposit``               — ``deposit_pallas`` (CIC deposit, periodic or
  bounded);
* ``deposit_det``           — ``deposit_pallas`` too, summed in a fixed order
  (the same bits every call; the sheath engine's deposits);
* ``gather``                — ``gather_pallas`` (CIC gather, periodic or
  bounded);
* ``leapfrog_gather_push_deposit`` — ``leapfrog_gather_push_deposit_pallas``
  (gather, kick-drift-kick, wrap, rho deposit at the new positions);
* ``explicit_cycle``        — ``explicit_cycle_pallas`` (the same sweep and
  the rho -> E solve, in one launch);
* ``explicit_cycle_resident`` — ``explicit_cycle_resident_pallas`` (S
  explicit cycles per launch with per-step metric rows, n <= 32768; one
  8-CTA cluster, its launch shape ``explicit_resident_shape``);
* ``picard_finalize``       — ``picard_finalize_pallas`` (the converged
  finalize sweep plus the full-step current deposit,
  finalize='converged-deposit');
* ``picard_iteration_shared`` — ``picard_iteration_pallas(share_window=True)``
  (the Picard pass depositing in the gather's window frame, clamps
  counted);
* ``implicit_resident``     — ``implicit_resident_pallas`` (S implicit
  CN-Picard steps per launch with per-step metric rows, n <= 131072; one
  16-CTA cluster, its launch shape ``implicit_resident_shape``);
* ``deposit2``              — ``deposit2_pallas`` (two bounded deposits,
  rho and n, in one sweep);
* ``boris_gather_push``     — ``boris_gather_push_pallas`` (bounded,
  optionally mirrored, gather + Boris-Buneman push);
* ``boris_gather_push_deposit`` — ``boris_gather_push_deposit_pallas`` (the
  same sweep and the carried rho and n deposit at the new positions,
  carried_deposit='on', clamps counted).

The kernels are in ``pypic_tpu_torch/csrc/cic.cu``, ``csrc/explicit.cu``,
``csrc/implicit.cu`` and ``csrc/magnetized.cu`` (built by ``_build``). The
magnetized engine's other two kernels, the sheath engine's three and the
domain engines' four have their own modules, ``ops/cuda_newton.py``,
``ops/cuda_rng.py``, ``ops/cuda_sheath.py`` and ``ops/cuda_domain.py``,
which count their launches in ``LAUNCHES`` here.

Dispatch rule, in this module only: a wrapper launches its kernel when its
tensors are CUDA tensors and runs its plain PyTorch version (``*_plain``)
when they lie on the CPU. Any other device, mixed devices or dtypes, a
dtype other than float32 and float64, or a non-contiguous or mis-shaped
tensor raises. Float64 (a float64 state, as the JAX package runs under
x64) runs on the CPU in every wrapper's plain version (not the slab
chain solve's, ``F32_ONLY``), and on the card in the wrappers with a
double kernel, ``F64_KERNELS`` (rows 1-6; the sheath engine's pass and
finalize, ``deposit_det``, ``sheath_reinject`` and ``hash_batch``; the
magnetized engine's rows 7-9 and its Newton solves, rows 22 and 23; the
explicit engine's rows 13 and 14: the ``_f64`` entry points, counted
under ``<wrapper>_f64``); any other wrapper raises
``NotImplementedError`` naming why it takes float32 only
(``check_dtype``: the JAX package runs its path in float32 alone). A
failed build or launch raises; nothing falls back. The card's size
limits (shared memory a block, thread histograms) are checked in the
CUDA branch only, so the plain versions run any grid size on CPU
tensors, as the JAX package does.

Grid sizes: the grid-stride kernels keep their (ng,) arrays in a block's
shared memory up to their ceilings and take the large modes above them,
up to ``LARGE_MAX_NG`` nodes (``smem_mode``, ``sweep_launch``: the field
read from device memory, every add a global float atomic); the wide
deposits do the same through ``deposit_launch_shape``. The Picard pass
(rows 1 and 2), the slab's Picard pass (row 17, ``cuda_domain``) and the
leapfrog deposit (row 14) choose through ``cluster_launch``: their
cluster mode (the sum in the shared memory of a thread-block cluster's
CTAs) and, in float32, their pair mode (a row's two adds one vector
reduction) where they beat the others on the card (``PASS_RULE``).
Only ``explicit_cycle`` keeps a ceiling below that (its engine calls it at
ng <= 1,024), and the resident kernels theirs.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel and nowhere else (the plain versions count nothing).
``LARGE_LAUNCHES`` counts, beside it, the launches taken in a large mode,
by "wrapper mode" (rows 1, 2, 14 and 17 also "cluster" and "pair").

Particles are flat (n,) tensors of grid coordinates. The TPU kernels'
blocked layout, window geometry, fold/selection matrices and SMEM scalar
packing are not ported.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..constants import EPSILON_0
from . import _build
from .accel import anderson_mix, mix_init
from .cic import cic_indices_weights
from .fd import smooth_periodic

# The wrappers with a float64 kernel on the card (ROADMAP queue 1, item
# 19: the implicit engine's rows 1-6; item 19a: the sheath engine's pass
# and finalize, deposit_det, the re-injection and the hash sampler; item
# 19b: the magnetized engine's rows 7-9 and its two Newton solves; item
# 19c: the explicit engine's rows 14 and 13). On CPU tensors every
# wrapper's plain version takes float64.
F64_KERNELS = ("picard_iteration", "picard_iteration_shared",
               "picard_finalize_nodep", "picard_finalize", "deposit", "gather",
               "sheath_picard", "sheath_finalize", "deposit_det",
               "sheath_reinject", "hash_batch", "deposit2", "boris_gather_push",
               "boris_gather_push_deposit", "boltzmann_dirichlet", "boltzmann_dn",
               "leapfrog_gather_push_deposit", "explicit_cycle")
LAUNCHES = {"picard_iteration": 0, "picard_finalize_nodep": 0, "deposit": 0,
            "gather": 0, "leapfrog_gather_push_deposit": 0,
            "explicit_cycle": 0, "explicit_cycle_resident": 0,
            "picard_finalize": 0, "picard_iteration_shared": 0,
            "implicit_resident": 0, "deposit2": 0, "boris_gather_push": 0,
            "boltzmann_dirichlet": 0, "boltzmann_dn": 0, "source_batch": 0,
            "source_uniforms": 0, "sheath_picard": 0, "sheath_finalize": 0,
            "sheath_reinject": 0, "sheath_uniforms": 0, "deposit_det": 0,
            "philox_uniforms": 0, "picard_iteration_ext": 0,
            "picard_finalize_ext_nodep": 0, "picard_finalize_ext": 0,
            "leapfrog_gather_push": 0, "boris_gather_push_deposit": 0,
            "explicit_domain_cycle": 0, "hash_batch": 0,
            "tridiag3_chain": 0, "boltzmann_dirichlet_large": 0,
            "boltzmann_dn_large": 0, "tridiag3_chain_large": 0,
            # the double kernels of a float64 state (rows 1-10, 13, 14,
            # 21-23, deposit_det and hash_batch) and the double Newton
            # large path
            **{f"{name}_f64": 0 for name in F64_KERNELS},
            "boltzmann_dirichlet_large_f64": 0, "boltzmann_dn_large_f64": 0}
# launches in a large mode, keyed "wrapper mode": "global", "field" for
# the carried Boris deposit (its field in shared memory up to
# FIELD_SMEM_MAX_NG), or "fixed" for the fixed-point sums of the sheath
# pass and finalize and deposit_det
LARGE_LAUNCHES: collections.Counter = collections.Counter()

_THREADS = 256
_BLOCKS_PER_SM = 8  # 8 x 256 threads fill an SM's 2048 thread slots
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448
# lane columns a histogram of the wide deposits at most (deposit_launch_shape)
DEPOSIT_MAX_COLS = 32
# room left beside the field for a kernel's static shared memory (as
# ptxas -v reports it: the carried Boris deposit's clamp count takes 16
# B, the sheath pass's large mode its sums' scratch 384), which a
# block's SMEM_LIMIT includes
STATIC_SMEM_ROOM = 1024
# the field alone in one block's shared memory beside that room (csrc
# kFieldSmemMaxNg): the large modes of the carried Boris deposit, the
# sheath pass and deposit_det keep it there up to this ng, and read it
# from device memory above
FIELD_SMEM_MAX_NG = (SMEM_LIMIT - STATIC_SMEM_ROOM) // 4


def field_smem_max_ng(item: int = 4) -> int:
    """The nodes of a field of ``item``-byte elements one block's shared
    memory holds beside STATIC_SMEM_ROOM (csrc/cic_common.cuh
    field_smem_max_ng): FIELD_SMEM_MAX_NG = 57,856 floats, 28,928
    doubles."""
    return (SMEM_LIMIT - STATIC_SMEM_ROOM) // item


# the large modes' limit on ng (every kernel with a large mode): float32
# positions below 2^22 still resolve a quarter cell, and the int64 sums
# of deposit_det take 8 ng bytes (32 MiB here)
LARGE_MAX_NG = 1 << 22
# the modes of the grid-stride kernels (csrc/cic_common.cuh kShared,
# kGlobal; kCluster and kPair rows 1, 2, 14 and 17 alone, cluster_launch),
# as the launchers take them
SMEM_MODES = {"shared": 0, "global": 1, "cluster": 2, "pair": 3}
# static shared memory beside the dynamic bytes (ptxas -v on sm_90a): one
# int (a clamp count a block, det_flush's ticket) takes 16 B, the
# granule; the 32 doubles of the slab finalizes' block_sum 256. A block's
# SMEM_LIMIT holds them too, so every launch shape counts them;
# tests/test_torch_cuda.py holds these tables to the compiler's report.
STATIC_INT_BYTES, STATS_BYTES = 16, 256
# the grid-stride kernels (sweep_launch): the float32 arrays of ng nodes a
# block keeps in shared memory in the shared mode (the field first, then
# the histogram) and the kernel's static shared bytes
SWEEP_KERNELS = {
    "picard_iteration": (2, 0), "picard_iteration_shared": (2, STATIC_INT_BYTES),
    "picard_finalize_nodep": (1, 0), "picard_finalize": (2, 0),
    "gather": (1, 0), "leapfrog_gather_push_deposit": (2, 0),
    "boris_gather_push": (1, 0), "picard_iteration_ext": (2, 0),
    "picard_iteration_ext shared": (2, STATIC_INT_BYTES),
    "picard_finalize_ext": (2, STATS_BYTES),
    "picard_finalize_ext_nodep": (1, STATS_BYTES),
    "leapfrog_gather_push": (1, 0),
    # the global field; the slab's histogram (ext_n floats) is `extra`
    "explicit_domain_cycle": (1, STATIC_INT_BYTES),
}
# the CUDA kernels (csrc) behind the entries of the launch tables whose
# static bytes the launch shapes count: (kernel name, {template argument
# index: value} of its instantiations), for check_static_smem
STATIC_SMEM_KERNELS = {
    "picard_iteration": ("picard_iteration_kernel", {1: 0}),
    "picard_iteration_shared": ("picard_iteration_kernel", {1: 1}),
    "picard_finalize_nodep": ("picard_finalize_kernel", {0: 0}),
    "picard_finalize": ("picard_finalize_kernel", {0: 1}),
    "gather": ("gather_kernel", {}),
    "leapfrog_gather_push_deposit": ("leapfrog_deposit_kernel", {}),
    "boris_gather_push": ("boris_kernel", {}),
    "picard_iteration_ext": ("picard_iteration_ext_kernel", {1: 0}),
    "picard_iteration_ext shared": ("picard_iteration_ext_kernel", {1: 1}),
    "picard_finalize_ext": ("picard_finalize_ext_kernel", {0: 1}),
    "picard_finalize_ext_nodep": ("picard_finalize_ext_kernel", {0: 0}),
    "leapfrog_gather_push": ("leapfrog_push_kernel", {}),
    "explicit_domain_cycle": ("domain_cycle_kernel", {}),
    "deposit": ("deposit_kernel", {}),
    "deposit2": ("deposit2_kernel", {}),
    "boris_gather_push_deposit": ("boris_deposit_kernel", {}),
    "sheath pass": ("sheath_pass_kernel", {}),
    "deposit_det": ("deposit_det_kernel", {}),
}
# the kernels whose large mode keeps the field in shared memory up to
# FIELD_SMEM_MAX_NG: their static bytes must fit STATIC_SMEM_ROOM
FIELD_SMEM_KERNELS = ("boris_deposit_global_kernel", "sheath_large_kernel")


def check_static_smem(log: str) -> list[str]:
    """The static shared bytes the compiler reports for each kernel
    (ptxas -v, a BuildInfo's ``log``) against those the launch shapes
    count: SWEEP_KERNELS, DEPOSIT_STATIC and cuda_sheath's
    SMALL_STATIC_BYTES through STATIC_SMEM_KERNELS, STATIC_SMEM_ROOM for
    FIELD_SMEM_KERNELS. A kernel whose bytes exceed its table's would ask
    for more than a block holds at its last shared node. Returns the
    excesses and the kernels missing from the report (empty if none)."""
    from .cuda_sheath import SMALL_STATIC_BYTES

    counted = {name: SWEEP_KERNELS[name][1] for name in SWEEP_KERNELS}
    counted.update(DEPOSIT_STATIC)
    counted.update({"sheath pass": SMALL_STATIC_BYTES, "deposit_det": SMALL_STATIC_BYTES})
    found = _build.static_smem(log)
    wanted = [(name, *STATIC_SMEM_KERNELS[name], counted[name]) for name in counted]
    wanted += [(name, name, {}, STATIC_SMEM_ROOM) for name in FIELD_SMEM_KERNELS]
    problems = []
    for name, kernel, args, room in wanted:
        got = [b for (k, a), b in found.items()
               if k == kernel and all(a[i] == v for i, v in args.items())]
        if not got:
            problems.append(f"{name}: no {kernel} {args} in the compiler's report")
        elif max(got) > room:
            problems.append(f"{name}: {kernel} {args} has {max(got)} static bytes, "
                            f"its launch shape counts {room}")
    return problems


# the double instantiations of the float64 kernels (rows 1-10, 13, 14,
# 21-23, deposit_det and hash_batch): (kernel, the index of its
# element-type template argument)
F64_INSTANCES = (("picard_iteration_kernel", 3), ("picard_finalize_kernel", 2),
                 ("deposit_kernel", 3), ("deposit_global_kernel", 3),
                 ("gather_kernel", 2),
                 # the sheath engine's (item 19a)
                 ("sheath_pass_kernel", 2), ("sheath_large_kernel", 4),
                 ("deposit_det_kernel", 2), ("deposit_det_large_kernel", 3),
                 ("sheath_reinject_kernel", 1), ("hash_batch_kernel", 1),
                 # the magnetized engine's (item 19b): rows 7-9, 22 and 23
                 ("deposit2_kernel", 3), ("deposit2_global_kernel", 3),
                 ("boris_kernel", 2), ("boris_deposit_kernel", 3),
                 ("boris_deposit_global_kernel", 4), ("newton_dd_kernel", 0),
                 ("newton_dn_kernel", 0), ("newton_dd_large_kernel", 0),
                 ("newton_dn_large_kernel", 0),
                 # the explicit engine's (item 19c): row 14 (both modes), row 13
                 ("leapfrog_deposit_kernel", 1), ("explicit_cycle_kernel", 0))


def check_f64_kernels(log: str) -> list[str]:
    """The float64 kernels missing a double instantiation in the
    compiler's report (ptxas -v, a BuildInfo's ``log``); empty if none.
    Their static shared bytes are held by ``check_static_smem`` beside
    the float ones' (the same table entries)."""
    found = _build.static_smem(log)
    return [f"{kernel}: no double instantiation in the compiler's report"
            for kernel, i in F64_INSTANCES
            if not any(k == kernel and len(a) > i and a[i] == "d" for k, a in found)]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LARGE_LAUNCHES.clear()


def _count(name: str, mode: str) -> None:
    LAUNCHES[name] += 1
    if mode != "shared":
        LARGE_LAUNCHES[f"{name} {mode}"] += 1


_F64_FLOAT32 = ("no gap: the JAX package runs this path in float32 only (ROADMAP.md "
                "queue 1, item 19)")
# why each other wrapper takes float32 alone on the card: the resident
# kernels' (the JAX engines' resident scans carry float32) and the slab
# engines' (float32 in the JAX package)
F64_ITEMS = {
    "explicit_cycle_resident": _F64_FLOAT32, "leapfrog_gather_push": _F64_FLOAT32,
    "implicit_resident": _F64_FLOAT32, "picard_iteration_ext": _F64_FLOAT32,
    "picard_finalize_ext": _F64_FLOAT32, "explicit_domain_cycle": _F64_FLOAT32,
}
# The wrappers that take float32 alone, on either device: the slab
# engines' chain solve (the JAX package runs the slab engines in float32).
F32_ONLY = ("tridiag3_chain",)


def check_engine_dtype(engine: str, device: torch.device, dtype: torch.dtype) -> None:
    """Raise TypeError for a state on the card that is neither float32 nor
    float64. Every single-device engine runs a float64 state on the card
    (its double kernels) and on the CPU (the plain versions), as the JAX
    engines run one under x64."""
    if device.type != "cuda" or dtype == torch.float32:
        return
    if dtype != torch.float64:
        raise TypeError(f"the {engine} engine takes a float32 or float64 state, "
                        f"got {dtype}")


def check_dtype(name: str, device: torch.device, dtype: torch.dtype) -> None:
    """Raise unless wrapper ``name`` runs ``dtype`` tensors on ``device``:
    float32 anywhere, float64 on the CPU (the plain versions; not the
    F32_ONLY wrapper) and on the card where the wrapper has a float64
    kernel (F64_KERNELS). A float64 tensor on the card without one raises
    NotImplementedError saying why (F64_ITEMS: the JAX package runs its
    path in float32 only); nothing falls back to the CPU."""
    if name in F32_ONLY and dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 tensors, got {dtype} (the JAX "
                        "package runs the slab engines in float32)")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: expected float32 or float64 tensors, got {dtype}")
    if device.type == "cuda" and dtype == torch.float64 and name not in F64_KERNELS:
        raise NotImplementedError(
            f"{name}: a float64 tensor on the card has no kernel (float64 "
            f"runs on the CPU): {F64_ITEMS[name]}")


def _device_kind(tensors, name: str) -> str:
    """'cuda' or 'cpu' for a set of tensors of one float dtype on one
    device that wrapper ``name`` takes there (``check_dtype``); raises on
    anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"{name}: tensors of different dtypes: {sorted(map(str, dtypes))}")
    check_dtype(name, dev, dtypes.pop())
    return dev.type


def _check_1d(name: str, t: torch.Tensor, size: int) -> None:
    if t.dim() != 1 or t.shape[0] != size:
        raise ValueError(f"{name} must have shape ({size},), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ng(ng: int) -> None:
    if ng < 2:
        raise ValueError(f"ng must be >= 2, got {ng}")


def _check_smem(ng: int, arrays: int, what: str, extra: int = 0, item: int = 4) -> None:
    """A block keeps ``arrays`` arrays of ng ``item``-byte elements (float32
    4, float64 8) and ``extra`` bytes in shared memory. A limit of the
    card's kernels only: the wrappers call it in their CUDA branch, so the
    plain versions on CPU tensors run any ng."""
    need = arrays * ng * item + extra
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{what}: ng={ng} needs {need} B of shared memory, "
            f"above the {SMEM_LIMIT} B a block may use (ng <= "
            f"{(SMEM_LIMIT - extra) // (item * arrays)})")


def check_large_ng(ng: int, what: str) -> None:
    """The large modes' limit (a limit of the card's kernels only)."""
    if ng > LARGE_MAX_NG:
        raise ValueError(f"{what}: ng={ng} is above LARGE_MAX_NG = {LARGE_MAX_NG}, "
                         "the large mode's limit (float32 positions resolve a "
                         "quarter cell below it)")


def smem_mode(nodes: int, arrays: int, extra: int = 0, static: int = 0,
              what: str = "kernel", item: int = 4) -> str:
    """The mode of a kernel whose block keeps ``arrays`` arrays of
    ``nodes`` elements of ``item`` bytes (float32 4, float64 8; the field
    first), ``extra`` dynamic bytes beside them and ``static`` bytes of
    its own (a clamp count's word, a reduction's scratch), a function of
    these sizes alone: 'shared' where all of it fits the block's
    SMEM_LIMIT (the kernels as first ported), else 'global' (the field
    read from device memory, every add a global atomic). Raises above
    LARGE_MAX_NG, naming ``what``."""
    if item * arrays * nodes + extra + static <= SMEM_LIMIT:
        return "shared"
    check_large_ng(nodes, what)
    return "global"


@dataclasses.dataclass(frozen=True)
class SweepLaunch:
    """The launch of a grid-stride kernel: its ``mode`` (``smem_mode``),
    ``blocks`` blocks of ``threads`` threads (a row a thread and pass, up
    to 8 blocks an SM), ``smem`` bytes of dynamic shared memory a block."""
    mode: str
    blocks: int
    threads: int
    smem: int


def sweep_launch(kernel: str, n: int, nodes: int, sms: int,
                 extra: int = 0, item: int = 4) -> SweepLaunch:
    """The launch of a grid-stride kernel (a key of SWEEP_KERNELS) on n
    rows and ``nodes`` nodes of its field, on a card of ``sms`` SMs, a
    function of these alone (``extra``: explicit_domain_cycle's slab
    histogram, 4 ext_n bytes; ``item``: the element's bytes, 8 for the
    double kernels of a float64 state, whose arrays take twice the
    bytes): its ``smem_mode`` and the shared memory its launcher asks for
    (the arrays and ``extra`` in 'shared', none in 'global'). Raises
    above LARGE_MAX_NG."""
    arrays, static = SWEEP_KERNELS[kernel]
    mode = smem_mode(nodes, arrays, extra, static, kernel.split()[0], item)
    smem = item * arrays * nodes + extra if mode == "shared" else 0
    return SweepLaunch(mode, max(1, min(-(-n // _THREADS), _BLOCKS_PER_SM * sms)),
                       _THREADS, smem)


# The cluster and pair modes of the Picard pass, rows 1 and 2 (csrc/cic.cu
# picard_iteration_kernel with kCluster, kPair), of the slab's Picard pass,
# row 17 in both windows (csrc/domain.cu picard_iteration_ext_kernel,
# float32 alone), and of the leapfrog deposit, row 14 (csrc/explicit.cu
# leapfrog_deposit_kernel). The cluster mode: CTAs of CLUSTER_THREADS
# threads, one an SM, in clusters of a power of two up to CLUSTER_MAX CTAs
# (16 a non-portable size), each CTA one slice of the (ng,) sum in its
# shared memory. The pair mode (float32 alone): sweep_launch's global
# grid, a row's two products one vector reduction into a (ng, 2) pair
# array ((ng + 1, 2) on row 17's bounded slab), folded after.
CLUSTER_KERNELS = ("picard_iteration", "picard_iteration_shared", "picard_iteration_ext",
                   "picard_iteration_ext shared", "leapfrog_gather_push_deposit")
CLUSTER_THREADS = 1024
CLUSTER_MAX = 16
# cluster_launch's rule by kernel and element bytes: (first node, mode) in
# rising order; below the first, sweep_launch's mode (the forced pairs
# that set it: cluster_launch's docstring)
PASS_RULE = {
    "picard_iteration": {4: ((16_384, "cluster"), (58_113, "pair")),
                         8: ((16_384, "cluster"), (58_113, "global"))},
    "picard_iteration_shared": {4: ((16_384, "cluster"), (57_344, "pair")),
                                8: ((16_384, "cluster"), (58_113, "global"))},
    "picard_iteration_ext": {4: ((16_384, "cluster"), (58_113, "pair"))},
    "picard_iteration_ext shared": {4: ((16_384, "cluster"), (58_109, "pair"))},
    "leapfrog_gather_push_deposit": {4: ((16_384, "cluster"), (58_113, "pair")),
                                     8: ((14_529, "cluster"), (58_113, "global"))},
}
# the rows a node, by element bytes, below which the cluster mode's flush
# (one global atomic a node and CTA, a CTA an SM) outweighs what it saves
# on the sweep, in every kernel of CLUSTER_KERNELS: there float32 takes the
# pair mode and float64 the global mode where PASS_RULE names the cluster
# mode (cluster_launch's docstring)
CLUSTER_MIN_ROWS_PER_NODE = {4: 64, 8: 48}


@dataclasses.dataclass(frozen=True)
class ClusterLaunch:
    """The launch of a kernel of CLUSTER_KERNELS: its ``mode`` ('shared',
    'global', 'cluster' or 'pair'), ``cluster`` CTAs a cluster (1 outside
    the cluster mode), ``blocks`` CTAs of ``threads`` threads and ``smem``
    bytes of dynamic shared memory a CTA."""
    mode: str
    cluster: int
    blocks: int
    threads: int
    smem: int


def cluster_size(kernel: str, nodes: int, item: int = 4) -> int | None:
    """The least power of two C up to CLUSTER_MAX whose slices of
    ceil(nodes / C) elements of ``item`` bytes fit a CTA beside the
    kernel's static bytes (SWEEP_KERNELS), or None if none does."""
    static = SWEEP_KERNELS[kernel][1]
    c = 1
    while c <= CLUSTER_MAX:
        if item * -(-nodes // c) + static <= SMEM_LIMIT:
            return c
        c *= 2
    return None


def cluster_nodes(kernel: str, item: int = 4) -> int:
    """The most nodes the largest cluster's slices hold (``cluster_size``
    at CLUSTER_MAX)."""
    return CLUSTER_MAX * ((SMEM_LIMIT - SWEEP_KERNELS[kernel][1]) // item)


def pass_mode(kernel: str, n: int, nodes: int, item: int = 4) -> str:
    """The mode PASS_RULE gives ``kernel`` on n rows and ``nodes`` nodes
    of ``item`` bytes: the last entry whose first node is at most
    ``nodes``, else sweep_launch's mode; on fewer than
    CLUSTER_MIN_ROWS_PER_NODE rows a node, the pair mode (float32) or the
    global mode (float64) in the cluster mode's place. Raises above
    LARGE_MAX_NG, and for an element size the kernel has no rule for (row
    17 takes float32 alone)."""
    if item not in PASS_RULE[kernel]:
        raise ValueError(f"{kernel}: no launch rule for {item}-byte elements (float32 alone)")
    mode = smem_mode(nodes, *SWEEP_KERNELS[kernel], what=kernel, item=item)
    for first, rule in PASS_RULE[kernel][item]:
        if nodes >= first:
            mode = rule
    if mode == "cluster" and n < CLUSTER_MIN_ROWS_PER_NODE[item] * nodes:
        mode = "pair" if item == 4 else "global"
    return mode


def cluster_launch(kernel: str, n: int, nodes: int, sms: int, item: int = 4,
                   clusters: int | None = None, mode: str | None = None) -> ClusterLaunch:
    """The launch of ``kernel`` (one of CLUSTER_KERNELS) on n rows and
    ``nodes`` nodes, a function of the sizes alone: the mode ``pass_mode``
    names. PASS_RULE comes from the forced pairs of PERF.md §6
    (chip_smoke.forced_mode_times, n = 1e7 and 1e8, NVIDIA H100 80GB
    HBM3, 700 W) and, for rows 14 and 17, from phase 41's paths with each
    mode forced in turns (chip_smoke._fused_turns, _slab_turns_rank).

    Rows 1 and 2 (the Picard pass): the shared mode up to 16,383 nodes,
    the cluster mode from 16,384, the smallest ng measured, where it beat
    both others at both n (row 1, float32: 0.0904 and 0.7910 ms against
    the shared mode's 0.4127 and 3.0166 and the global mode's 0.3127 and
    3.0564; float64 0.1655 and 1.5127 against 0.3370 and 3.2869). From
    58,113 nodes a cluster takes more than one CTA (C = 2 in float32, 4
    in float64): there, at 65,536, the float32 pair mode beat it at both
    n (0.1925 and 1.8524 against 0.2659 and 2.5246; the global mode 0.3459
    and 3.3988), and in float64 the global mode did (0.3664 and 3.6386
    against 0.4547 and 4.3954). So float32 takes the pair mode from
    58,113 nodes and float64 the global mode; row 2 in float32 from
    57,344, where the pair mode beat one CTA at both n (0.2163 and 2.1126
    against 0.2533 and 2.3741; row 1 there 0.1899 and 1.8243 against
    0.1822 and 1.7299).

    Rows 17 (the slab pass, both windows, float32) and 14 (the leapfrog
    deposit, float32 and float64), from their forced pairs at n = 1e7
    (ng 16,384 to 2^20, and every 2,048-4,096 nodes from 20,480 to
    57,344, twice) and 1e8: the cluster mode from 16,384 nodes (from
    14,529 in float64, the double shared mode's ceiling, where the global
    mode took over), where it beat every other mode at both n (row 17
    0.1031 ms at 1e7 against the global mode's 0.3168 and the pair mode's
    0.1759; row 14 0.0906 against 0.3222 and 0.1800; float64 0.1763
    against 0.3531), to the last node one CTA holds (58,112; 58,108 in
    row 17's shared window), above which (from 58,113; 58,109 in the
    shared window) float32 takes the pair mode (at 65,536 0.1960-0.1986
    against the two-CTA cluster's 0.2687-0.2702 and the global mode's
    0.3490-0.3528) and float64 the global mode (0.3718 against C = 4's
    0.4610). On random rows row 17's separate window lost its cluster
    mode to the pair mode at 26,624-28,672 and 53,248-57,344 nodes
    (0.2175-0.2482 against 0.1757-0.1981); on configs[4]'s own rows it
    did not: forced in turns at ext_n 27,769, 37,023 and 55,533 (n =
    1e7) row 17 took 0.91, 0.68 and 1.06 ms a step in the cluster mode
    against the pair mode's 3.98-4.02 and the global mode's 7.18-7.75
    (its shared window at 37,023 0.69 against 4.0 and 7.9), and the
    fused two-stream's row 14 at 32,768 0.133 against 0.172 and 0.31-0.33
    (float64 0.294-0.297 against 0.374-0.376): so one range, no bands.

    Below CLUSTER_MIN_ROWS_PER_NODE rows a node (64 in float32, 48 in
    float64; every kernel here) the cluster mode's flush, one global
    atomic a node and CTA, outweighs its sweep: in the forced pairs of
    rows 1, 2, 14 and 17 at n = 5e5 to 4e6 and ng 16,384, 32,768 and
    57,344 the float32 pair mode beat it at 30-35 rows a node (row 1 at
    57,344 and 2e6: 0.0398 ms against 0.0457) and it won from 61 rows a
    node at 16,384 and 32,768 (row 1 at 32,768 and 2e6: 0.0310 against
    0.0383); at 57,344 it lost by 3-10% at 70 rows a node (row 1 0.0842
    against 0.0773; row 17's separate window by 30%, 0.1100 against
    0.0846). In float64 the global mode beat it at 30-35 rows a node
    (0.0417 against 0.0392 at 32,768 and 1e6) and it won from 61 (0.0672
    against 0.0775 at 32,768 and 2e6). There float32 takes the pair mode
    and float64 the global mode.

    The shared and global modes launch as ``sweep_launch``; the pair mode
    on the global mode's grid. The cluster mode: C = ``cluster_size`` CTAs
    a cluster, each of CLUSTER_THREADS threads with a slice of
    ceil(nodes / C) elements, and C min(``clusters``, ceil(n / (C
    CLUSTER_THREADS))) CTAs, ``clusters`` the clusters the card holds at
    once (cudaOccupancyMaxActiveClusters; sms // C when None, the most it
    could). ``mode`` forces a mode (raising where it cannot launch).
    Raises above LARGE_MAX_NG."""
    sweep = sweep_launch(kernel, n, nodes, sms, item=item)
    mode = pass_mode(kernel, n, nodes, item) if mode is None else mode
    if mode == "shared" and sweep.mode != "shared":
        raise ValueError(f"{kernel}: ng={nodes} is above the shared mode's ceiling")
    if mode == "pair" and item != 4:
        raise ValueError(f"{kernel}: the pair mode takes float32 alone")
    if mode != "cluster":
        smem = sweep.smem if mode == "shared" else 0
        return ClusterLaunch(mode, 1, sweep.blocks, sweep.threads, smem)
    c = cluster_size(kernel, nodes, item)
    if c is None:
        raise ValueError(f"{kernel}: ng={nodes} is above the cluster mode's "
                         f"{cluster_nodes(kernel, item)} nodes")
    clusters = sms // c if clusters is None else clusters
    if clusters < 1:
        raise RuntimeError(f"{kernel}: the card holds no cluster of {c} CTAs")
    count = max(1, min(clusters, -(-n // (c * CLUSTER_THREADS))))
    return ClusterLaunch("cluster", c, c * count, CLUSTER_THREADS, item * -(-nodes // c))


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, kernel: str, item: int, emit_v: bool, nodes: int,
                  cluster: int) -> int:
    """Clusters of ``kernel``'s cluster launch the card ``index`` holds at
    once (cudaOccupancyMaxActiveClusters); raises if it cannot hold one."""
    count = ctypes.c_int(0)
    lib = _build.library()
    with torch.cuda.device(index):
        if kernel.startswith("picard_iteration_ext"):
            err = lib.pypic_picard_iteration_ext_clusters(
                int(kernel.endswith(" shared")), int(emit_v), nodes, cluster,
                CLUSTER_THREADS, ctypes.byref(count))
        elif kernel == "leapfrog_gather_push_deposit":
            err = lib.pypic_leapfrog_deposit_clusters(
                int(item == 8), nodes, cluster, CLUSTER_THREADS, ctypes.byref(count))
        else:
            err = lib.pypic_picard_iteration_clusters(
                int(kernel == "picard_iteration_shared"), int(emit_v), int(item == 8),
                nodes, cluster, CLUSTER_THREADS, ctypes.byref(count))
    _build.check(err, f"{kernel} (cluster occupancy)")
    if count.value < 1:
        raise RuntimeError(
            f"{kernel}: {torch.cuda.get_device_name(index)} cannot hold one cluster "
            f"of {cluster} CTAs x {CLUSTER_THREADS} threads at ng = {nodes} "
            "(cudaOccupancyMaxActiveClusters = 0)")
    return count.value


def _pass_launch(dev, kernel: str, n: int, nodes: int, item: int, emit_v: bool,
                 mode: str | None = None) -> ClusterLaunch:
    """``cluster_launch`` on card ``dev``, its clusters queried there."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _sm_count(index)
    launch = cluster_launch(kernel, n, nodes, sms, item, mode=mode)
    if launch.mode != "cluster":
        return launch
    held = _max_clusters(index, kernel, item, emit_v, nodes, launch.cluster)
    return cluster_launch(kernel, n, nodes, sms, item, held, mode="cluster")


def pair_rows(ng: int, bounded: bool = False) -> int:
    """The rows of the pair mode's (rows, 2) pair array: ng, or ng + 1 on a
    bounded slab (row l + 1 holds node l's product and node l + 1's)."""
    return ng + 1 if bounded else ng


def _pass_sum(mode: str, ng: int, dtype: torch.dtype, dev,
              bounded: bool = False) -> torch.Tensor:
    """The zeroed sum of a kernel of CLUSTER_KERNELS: ng elements, in the
    pair mode the pair array's 2 ``pair_rows`` elements before them (the
    sum the fold writes: the last ng)."""
    pair = 2 * pair_rows(ng, bounded) if mode == "pair" else 0
    return torch.zeros((pair + ng,), dtype=dtype, device=dev)


def _sweep(dev, kernel: str, n: int, nodes: int, extra: int = 0,
           item: int = 4) -> SweepLaunch:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return sweep_launch(kernel, n, nodes, _sm_count(index), extra, item)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(n: int, device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return max(1, min(-(-n // _THREADS), _BLOCKS_PER_SM * _sm_count(index)))


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def _launcher(lib, name: str, dtype: torch.dtype, large: bool = False,
              entry: str | None = None):
    """(launcher, count name) of wrapper ``name`` for ``dtype``: the
    double kernel's entry point and its own count for float64; ``large``
    the ``*_large`` entry point (the fixed-point sums), counted as the
    wrapper; ``entry`` the entry point's stem where it is not the
    wrapper's name."""
    suffix = "_f64" if dtype == torch.float64 else ""
    launcher = f"pypic_{entry or name}{'_large' if large else ''}{suffix}"
    return getattr(lib, launcher), f"{name}{suffix}"


def real(dtype: torch.dtype):
    """The numpy scalar type of a state dtype: the host scalars of a step
    round to it, as JAX's weakly typed Python floats round to the
    state's dtype (float32 for any dtype but float64)."""
    return np.float64 if dtype == torch.float64 else np.float32


def kernel_scalars(qm: float, dt: float, dx: float, w: float,
                   dtype: torch.dtype = torch.float32):
    """Kernel scalars as ``pallas_cic._scalars`` computes them: arithmetic
    in ``dtype`` from q/m in ``dtype``, in the same order.
    Returns (qm dt, qm dt (dt/dx) / 2, dt/dx, w), each a Python float
    holding a value of ``dtype``."""
    f = real(dtype)
    qm = f(qm)
    qm_dt = qm * f(dt)
    qm_dt2_half = f(0.5) * qm * f(dt) * f(dt / dx)
    return float(qm_dt), float(qm_dt2_half), float(f(dt / dx)), float(f(w))


def leapfrog_scalars(qm: float, dt: float, dx: float, w: float,
                     dtype: torch.dtype = torch.float32):
    """Scalars of the leapfrog kernels as the Pallas wrappers compute them
    (pallas_cic.py:868-871, 1097-1100): ``0.5 * qm * dt`` in ``dtype``
    from q/m in ``dtype``, ``dt / dx`` and ``w`` rounded to it.
    Returns (qm dt / 2, dt/dx, w), each a Python float holding a value of
    ``dtype``."""
    f = real(dtype)
    qmh = f(0.5) * f(qm) * f(dt)
    return float(qmh), float(f(dt / dx)), float(f(w))


def _inv(ng: int, dtype: torch.dtype = torch.float32) -> float:
    return float(real(dtype)(1.0 / ng))


def _solve_coef(dx: float) -> float:
    """dx / (2 eps0): the factor of the direct-form field solve."""
    return dx / (2.0 * EPSILON_0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gather_plain(field, p, *, periodic: bool):
    """CIC gather by advanced indexing (ops/cic.py ``gather``, 'take')."""
    ng = field.shape[0]
    il, ir, wl, wr = cic_indices_weights(p, ng if periodic else ng - 1, periodic)
    return field[il] * wl + field[ir] * wr


def _wrap(x, ng: int):
    return x - torch.floor(x * _inv(ng, x.dtype)) * ng


def _cn_push(field, ps, p0, v0, qm_dt, qm_dt2_half, dt_dx):
    e_p = gather_plain(field, ps, periodic=True)
    p1 = p0 + dt_dx * v0 + qm_dt2_half * e_p
    v1 = v0 + qm_dt * e_p
    return p1, v1


def deposit_plain(p, values, ng: int, *, periodic: bool):
    """CIC deposit by two ``index_add_`` (ops/cic.py _deposit_scatter)."""
    num_cells = ng if periodic else ng - 1
    il, ir, wl, wr = cic_indices_weights(p, num_cells, periodic)
    out = torch.zeros((ng,), dtype=values.dtype, device=values.device)
    out.index_add_(0, il, values * wl)
    out.index_add_(0, ir, values * wr)
    return out


def deposit_terms_plain(p, values, ng: int, *, periodic: bool):
    """(nodes, terms) of the CIC deposit: each row's value w_l at its left
    node and value w_r at its right (the products ``deposit_plain`` sums
    and the deposit kernels add), left terms first."""
    num_cells = ng if periodic else ng - 1
    il, ir, wl, wr = cic_indices_weights(p, num_cells, periodic)
    return torch.cat([il, ir]), torch.cat([values * wl, values * wr])


def fixed2_bits(n: int) -> int:
    """L, the fraction bits of the two-word sums over n rows
    (csrc/cic_common.cuh fixed2_bits): min(44, 62 - ceil(log2 2n))."""
    return min(44, 62 - (2 * n - 1).bit_length())


def fixed2_sum_plain(nodes, terms, ng: int, n: int):
    """The double large mode's node sums (csrc/cic_common.cuh "Two-word
    sums") as int64 tensor operations, bit for bit: the scale 2^k from the
    largest |term| M (k = 62 - e, 2 n M < 2^e), each term's words hi =
    rint(t 2^k) and lo = rint((t 2^k - hi) 2^L), their int64 sums a node,
    lo's integer part carried into hi, and the pair rounded once to
    float64 over 2^k. ``nodes`` (int64) and ``terms`` (float64) as
    ``deposit_terms_plain`` gives them, ``n`` the rows of the call (the
    kernels' scale counts them). A non-finite term, or a 2 n M that
    overflows, makes every node NaN. Each term rounds by at most
    2^-(k+L+1); the sums' bits depend on no order."""
    terms = terms.to(torch.float64)
    dev = terms.device
    m = float(terms.abs().max()) if terms.numel() else 0.0
    big = 2.0 * n * m
    if not math.isfinite(big):
        return torch.full((ng,), math.nan, dtype=torch.float64, device=dev)
    scale = 1.0 if m == 0.0 else math.ldexp(1.0, 62 - math.frexp(big)[1])
    bits = fixed2_bits(n)
    unit = 1 << bits
    x = terms * scale  # exact: a power of two
    hi = torch.round(x)  # half to even, as __double2ll_rn
    lo = torch.round((x - hi) * float(unit)).to(torch.int64)
    acc_hi = torch.zeros((ng,), dtype=torch.int64, device=dev).index_add_(
        0, nodes, hi.to(torch.int64))
    acc_lo = torch.zeros((ng,), dtype=torch.int64, device=dev).index_add_(0, nodes, lo)
    carry = acc_lo >> bits  # an arithmetic shift: floor(lo / 2^L)
    acc_hi = acc_hi + carry
    acc_lo = acc_lo - carry * unit
    a = acc_hi.to(torch.float64)
    rest = (acc_hi - a.to(torch.int64)) * unit + acc_lo  # below 2^53: exact
    return (a + rest.to(torch.float64) * (1.0 / unit)) * (1.0 / scale)


def picard_iteration_plain(field_smoothed, ps, p0, v0, ng: int, *, qm, w,
                           dt: float, dx: float, emit_v: bool = False):
    qm_dt, qm_dt2_half, dt_dx, w = kernel_scalars(qm, dt, dx, w, ps.dtype)
    p1, v1 = _cn_push(field_smoothed, ps, p0, v0, qm_dt, qm_dt2_half, dt_dx)
    ph = _wrap(0.5 * (p0 + p1), ng)
    vh = 0.5 * (v0 + v1)
    jh = deposit_plain(ph, w * vh, ng, periodic=True)
    return (ph, v1, jh) if emit_v else (ph, jh)


def picard_finalize_nodep_plain(field_smoothed, ps, p0, v0, ng: int, *, qm,
                                dt: float, dx: float):
    qm_dt, qm_dt2_half, dt_dx, _ = kernel_scalars(qm, dt, dx, 0.0, ps.dtype)
    p1, v1 = _cn_push(field_smoothed, ps, p0, v0, qm_dt, qm_dt2_half, dt_dx)
    return _wrap(p1, ng), v1


def picard_finalize_plain(field_smoothed, ps, p0, v0, ng: int, *, qm, w,
                          dt: float, dx: float):
    p1, v1 = picard_finalize_nodep_plain(field_smoothed, ps, p0, v0, ng,
                                         qm=qm, dt=dt, dx=dx)
    wf = kernel_scalars(qm, dt, dx, w, ps.dtype)[3]
    return p1, v1, deposit_plain(p1, wf * v1, ng, periodic=True)


def window_sw(ng: int) -> tuple[int, int]:
    """(stride, width) of the shared-window Picard pass's frame, the cost
    rule of ``pallas_cic._choose_window_sw`` copied: minimize
    3 width + 2 K over the widths the TPU kernel tiles, stride = width - 4,
    K = (ng - 1) // stride + 1 windows.

    The rule was tuned for the TPU's tiling and has no cost meaning on the
    GPU. It exists here because the frame decides which deposits the JAX
    kernel clamps, and so the ``picard_clamped`` metric: the port keeps the
    frame to keep that observable (ng 64 -> (4, 8), ng 200 -> (12, 16)).
    """
    return _tpu_frame(ng, margin=4, k_weight=2)


def _tpu_frame(ng: int, margin: int, k_weight: int) -> tuple[int, int]:
    """(stride, width) minimizing 3 width + k_weight K over the widths the
    TPU kernels tile, stride = width - margin, K = (ng - 1) // stride + 1
    (``pallas_cic._choose_window`` and ``_choose_window_sw``)."""
    best = None
    for width in (8, 16, 24, 32, 48, 64, 96, 128):
        stride = width - margin
        cost = 3 * width + k_weight * ((ng - 1) // stride + 1)
        if best is None or cost < best[2]:
            best = (stride, width, cost)
    return best[0], best[1]


def _shared_frame_args(ng: int, dtype: torch.dtype = torch.float32):
    """(stride, width, K, 1/stride in ``dtype``) of the shared-window
    frame."""
    stride, width = window_sw(ng)
    return stride, width, (ng - 1) // stride + 1, float(real(dtype)(1.0 / stride))


def _shared_frame_cic(ps, raw, ng: int):
    """(left node, right node, w_r, clamped) of the shared-window pass's
    deposit: the midpoint ``raw`` as seen from the gather's window frame
    at ``ps`` (pallas_cic.py _window_decompose, _shared_gather and
    _picard_iter_sw_kernel), clamped to the frame's edge."""
    stride, width, num_k, inv_stride = _shared_frame_args(ng, ps.dtype)
    k = torch.clamp((torch.floor(ps) * inv_stride).to(torch.int32), 0, num_k - 1)
    d_s = (ps - k.to(ps.dtype) * stride) + 1.0
    delta = raw - ps
    delta = delta - torch.round(delta * _inv(ng, ps.dtype)) * ng  # nearest image
    d_h = d_s + delta
    oob = (d_h < 0.0) | (d_h > width - 1.0)
    d_h = torch.clamp(d_h, 0.0, width - 1.0)
    row = torch.clamp(torch.floor(d_h).to(torch.int64), max=width - 2)
    wr = d_h - row.to(d_h.dtype)
    node = torch.remainder(stride * k.to(torch.int64) + row - 1, ng)
    right = torch.where(node + 1 == ng, 0, node + 1)
    return node, right, wr, oob


def picard_iteration_shared_plain(field_smoothed, ps, p0, v0, ng: int, *, qm,
                                  w, dt: float, dx: float,
                                  emit_v: bool = False, acc_dtype=None):
    """``acc_dtype`` is the dtype jh is summed in (the inputs' by
    default): float64 sums the same float32 terms into a reference for
    the kernel's float32 sums."""
    qm_dt, qm_dt2_half, dt_dx, w = kernel_scalars(qm, dt, dx, w, ps.dtype)
    p1, v1 = _cn_push(field_smoothed, ps, p0, v0, qm_dt, qm_dt2_half, dt_dx)
    raw = 0.5 * (p0 + p1)
    vh = 0.5 * (v0 + v1)
    node, right, wr, oob = _shared_frame_cic(ps, raw, ng)
    vals = w * vh
    acc = acc_dtype or vals.dtype
    jh = torch.zeros((ng,), dtype=acc, device=vals.device)
    jh.index_add_(0, node, (vals * (1.0 - wr)).to(acc))
    jh.index_add_(0, right, (vals * wr).to(acc))
    n_clamped = oob.sum().to(torch.int32)
    ph = _wrap(raw, ng)
    return (ph, v1, jh, n_clamped) if emit_v else (ph, jh, n_clamped)


def cluster_sum_plain(left, right, t_left, t_right, ng: int, cluster: int,
                      slice_: int, bounded: bool = False):
    """The cluster mode's sum of a kernel's terms (csrc/cic_common.cuh
    cluster_add and the flush), on any device: term ``t_left`` at node
    ``left`` lands in slice ``left // slice_`` at offset ``left % slice_``
    of ``cluster`` slices of ``slice_`` nodes, ``t_right`` at the next
    offset, at the next slice's first past ``slice_ - 1`` and at node 0's
    (slice 0, offset 0) where ``right`` wrapped to 0; the slices, laid end
    to end, are the (ng,) sum. ``bounded`` (the slab, row 17:
    cluster_add_bounded): ``t_right`` at node ``right`` = ``left`` + 1, no
    wrap, and a term whose node lies outside [0, ng) dropped, as the
    global mode drops it. Raises if a term lands past node ng - 1 (owner
    or offset arithmetic the flush would drop)."""
    if cluster * slice_ < ng:
        raise ValueError(f"{cluster} slices of {slice_} nodes do not hold ng = {ng}")
    slices = torch.zeros((cluster * slice_,), dtype=t_left.dtype, device=t_left.device)
    if bounded:
        for node, term in ((left, t_left), (right, t_right)):
            keep = (node >= 0) & (node < ng)
            node, term = node[keep], term[keep]
            owner = torch.div(node, slice_, rounding_mode="floor")
            slices.index_add_(0, owner * slice_ + (node - owner * slice_), term)
    else:
        owner = torch.div(left, slice_, rounding_mode="floor")
        off = left - owner * slice_
        r_owner = torch.where(off + 1 == slice_, owner + 1, owner)
        r_off = torch.where(off + 1 == slice_, 0, off + 1)
        r_owner = torch.where(right == 0, 0, r_owner)
        r_off = torch.where(right == 0, 0, r_off)
        slices.index_add_(0, owner * slice_ + off, t_left)
        slices.index_add_(0, r_owner * slice_ + r_off, t_right)
    if bool((slices[ng:] != 0).any()):
        raise AssertionError("a term landed past the last node")
    return slices[:ng]


def pair_sum_plain(left, t_left, t_right, ng: int, bounded: bool = False):
    """The pair mode's sum of a kernel's terms (csrc/cic_common.cuh pair_add
    and pair_fold_kernel), on any device: both terms of a row at row
    ``left`` of a (ng, 2) pair array, then jh[i] = pair[i][0] + pair[i -
    1][1], i - 1 taken mod ng. ``bounded`` (the slab, row 17:
    pair_fold_bounded_kernel): at row ``left`` + 1 of an (ng + 1, 2) array,
    a row with ``left`` outside [-1, ng) dropped, then jh[i] = pair[i +
    1][0] + pair[i][1] (pair[0][0], node -1, and pair[ng][1], node ng,
    never read)."""
    rows = pair_rows(ng, bounded)
    row = left + 1 if bounded else left
    keep = (row >= 0) & (row < rows)
    pair = torch.zeros((rows, 2), dtype=t_left.dtype, device=t_left.device)
    pair[:, 0].index_add_(0, row[keep], t_left[keep])
    pair[:, 1].index_add_(0, row[keep], t_right[keep])
    if bounded:
        return pair[1:, 0] + pair[:-1, 1]
    return pair[:, 0] + torch.roll(pair[:, 1], 1)


def mode_sum_plain(mode: str, left, right, t_left, t_right, ng: int, cluster: int = 1,
                   bounded: bool = False):
    """The (ng,) sum of a kernel's terms as its ``mode`` sums them:
    'cluster' (``cluster_sum_plain`` over ``cluster`` slices of ceil(ng /
    cluster) nodes) or 'pair' (``pair_sum_plain``)."""
    if mode == "cluster":
        return cluster_sum_plain(left, right, t_left, t_right, ng, cluster,
                                 -(-ng // cluster), bounded)
    if mode == "pair":
        return pair_sum_plain(left, t_left, t_right, ng, bounded)
    raise ValueError(f"mode must be 'cluster' or 'pair', got {mode!r}")


def picard_iteration_cluster_plain(field_smoothed, ps, p0, v0, ng: int, *, qm,
                                   w, dt: float, dx: float, cluster: int,
                                   slice_: int, share_window: bool = False):
    """The cluster mode's pass on the CPU: ``picard_iteration_plain``'s
    (``picard_iteration_shared_plain``'s with ``share_window``) ph, v1
    and clamp count, its jh summed as ``cluster_sum_plain`` sums it over
    ``cluster`` slices of ``slice_`` nodes. Returns (ph, v1, jh) or
    (ph, v1, jh, n_clamped)."""
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w, ps.dtype)
    p1, v1 = _cn_push(field_smoothed, ps, p0, v0, qm_dt, qm_dt2_half, dt_dx)
    raw = 0.5 * (p0 + p1)
    vals = wf * (0.5 * (v0 + v1))
    ph = _wrap(raw, ng)
    if share_window:
        left, right, wr, oob = _shared_frame_cic(ps, raw, ng)
        wl = 1.0 - wr
    else:
        left, right, wl, wr = cic_indices_weights(ph, ng, True)
    jh = cluster_sum_plain(left, right, vals * wl, vals * wr, ng, cluster, slice_)
    if share_window:
        return ph, v1, jh, oob.sum().to(torch.int32)
    return ph, v1, jh


def implicit_resident_plain(e0, e_prev, j0, p, v, ng: int, steps: int, *, qm,
                            w, ke_c: float, dt: float, dx: float, tol: float,
                            maxiter: int, extrapolate: bool, anderson: bool,
                            fe_c: float, tracer: int, smooth: bool = True):
    """``steps`` implicit steps one by one: the engine's fused step with
    finalize='converged', finalize_field='last' and separate windows, from
    the plain pass and finalize versions. Returns what
    ``implicit_resident`` returns."""
    sm = smooth_periodic if smooth else (lambda f: f)
    tol = float(np.float32(tol))
    dt_eps = dt / EPSILON_0
    jb_c = float(np.float32(kernel_scalars(qm, dt, dx, w)[3]) / np.float32(ng))
    n = p.shape[0]
    rows = {k: [] for k in ("fe", "ke", "jb", "iters", "resid", "tracer_x",
                            "tracer_v")}
    jh = j0
    for _ in range(int(steps)):
        es = e0 + 0.5 * (e0 - e_prev) if extrapolate else e0
        ps, e1, k = p, e0, 0
        r = torch.full((), float("inf"), dtype=e0.dtype, device=e0.device)
        aux = mix_init(e0, "anderson" if anderson else "none")
        while r.item() > tol and k < maxiter:
            ps, jh = picard_iteration_plain(sm(es), ps, p, v, ng, qm=qm, w=w,
                                            dt=dt, dx=dx)
            e1 = e0 + dt_eps * (torch.mean(jh) - sm(jh))
            eh = 0.5 * (e1 + e0)
            r = torch.sum((es - eh) ** 2)
            es, aux = anderson_mix(es, eh, k, aux) if anderson else (eh, aux)
            k += 1
        p, v = picard_finalize_nodep_plain(sm(es), ps, p, v, ng, qm=qm,
                                           dt=dt, dx=dx)
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        rows["fe"].append(fe_c * torch.sum(e1 * e1))
        rows["ke"].append(ke_c * torch.sum(v * v))
        rows["jb"].append(jb_c * torch.sum(v))
        rows["iters"].append(torch.tensor(k, dtype=torch.int32, device=p.device))
        rows["resid"].append(r)
        rows["tracer_x"].append(p[tracer] if 0 <= tracer < n else zero)
        rows["tracer_v"].append(v[tracer] if 0 <= tracer < n else zero)
        e_prev, e0 = e0, e1
    return p, v, e0, e_prev, jh, {k: torch.stack(r) for k, r in rows.items()}


def _leapfrog(field, p, v, qmh: float, dt_dx: float, ng: int):
    """Kick-drift-kick and the periodic wrap, in the kernels' operation
    order (pallas_cic.py:834-846)."""
    kick = qmh * gather_plain(field, p, periodic=True)
    vh = v + kick
    return _wrap(p + vh * dt_dx, ng), vh + kick


def field_from_rho_plain(rho, dx: float):
    """The periodic field of rho in the direct form the explicit kernels
    use: the neutralized Poisson solve and the centered gradient of
    ``ops/poisson.py`` + ``ops/fd.py`` as one O(ng) prefix sum, in float64,
    rounded to rho's dtype once. With T = cumsum(rho - mean(rho)) and
    d = T - mean(T), e_i = dx / (2 eps0) (d_i + d_{i-1}), d_{-1} = d_{ng-1}.
    """
    r = rho.double()
    t = torch.cumsum(r - r.mean(), 0)
    d = t - t.mean()
    return (_solve_coef(dx) * (d + torch.roll(d, 1))).to(rho.dtype)


def leapfrog_gather_push_deposit_plain(field, p, v, *, qm, w, dt: float,
                                       dx: float):
    ng = field.shape[0]
    qmh, dt_dx, wf = leapfrog_scalars(qm, dt, dx, w, p.dtype)
    p1, v1 = _leapfrog(field, p, v, qmh, dt_dx, ng)
    return p1, v1, deposit_plain(p1, torch.full_like(p1, wf), ng, periodic=True)


def leapfrog_gather_push_deposit_cluster_plain(field, p, v, *, qm, w, dt: float,
                                               dx: float, mode: str = "cluster",
                                               cluster: int = 1):
    """Row 14's cluster or pair mode on any device: the plain version's p1
    and v1, rho summed as ``mode_sum_plain`` sums the kernel's terms (w wl
    at the left node, w wr at the right) in ``mode`` over ``cluster``
    CTAs."""
    ng = field.shape[0]
    qmh, dt_dx, wf = leapfrog_scalars(qm, dt, dx, w, p.dtype)
    p1, v1 = _leapfrog(field, p, v, qmh, dt_dx, ng)
    il, ir, wl, wr = cic_indices_weights(p1, ng, True)
    return p1, v1, mode_sum_plain(mode, il, ir, wf * wl, wf * wr, ng, cluster)


def explicit_cycle_plain(e_field, p, v, ng: int, *, qm, w, dt: float,
                         dx: float):
    p1, v1, rho1 = leapfrog_gather_push_deposit_plain(e_field, p, v, qm=qm,
                                                      w=w, dt=dt, dx=dx)
    return p1, v1, rho1, field_from_rho_plain(rho1, dx)


def explicit_cycle_resident_plain(e_field, p, v, ng: int, steps: int, *, qm,
                                  w, ke_c: float, jb_c: float, dt: float,
                                  dx: float, fe_c: float):
    """``steps`` plain explicit cycles with the pre-push metric rows
    fe = fe_c sum(e^2), ke = ke_c sum(v^2), jb = jb_c sum(v), written as
    the explicit engine's step writes them."""
    fe, ke, jb = [], [], []
    rho = None
    for _ in range(steps):
        fe.append(fe_c * torch.sum(e_field * e_field))
        ke.append(ke_c * torch.dot(v, v))
        jb.append(jb_c * torch.sum(v))
        p, v, rho, e_field = explicit_cycle_plain(e_field, p, v, ng, qm=qm,
                                                  w=w, dt=dt, dx=dx)
    return (p, v, rho, e_field, torch.stack(fe), torch.stack(ke),
            torch.stack(jb))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_pass(name, field, ps, p0, v0, ng):
    kind = _device_kind((field, ps, p0, v0), name)
    _check_1d("field", field, ng)
    n = ps.shape[0] if ps.dim() == 1 else -1
    for name, t in (("ps", ps), ("p0", p0), ("v0", v0)):
        _check_1d(name, t, n)
    return kind, n


def picard_iteration(field_smoothed, ps, p0, v0, ng: int, *, qm, w,
                     dt: float, dx: float, emit_v: bool = False):
    """Fused Picard inner pass. Returns (ph, jh) — the wrapped half-step
    positions (the next pass's gather guess) and the (ng,) half-step
    current — or (ph, v1, jh) with ``emit_v`` (the iterate's full-step
    velocity). ``qm`` and ``w`` are the scalars q/m and q p2c / dx of
    the state's dtype (rounded to the tensors' by ``kernel_scalars``)."""
    kind, n = _check_pass("picard_iteration", field_smoothed, ps, p0, v0, ng)
    _check_ng(ng)
    if kind == "cpu":
        return picard_iteration_plain(field_smoothed, ps, p0, v0, ng, qm=qm,
                                      w=w, dt=dt, dx=dx, emit_v=emit_v)
    dev, dtype = ps.device, ps.dtype
    launch = _pass_launch(dev, "picard_iteration", n, ng, ps.element_size(), emit_v)
    fn, name = _launcher(_build.library(), "picard_iteration", dtype)
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w, dtype)
    ph = torch.empty_like(ps)
    v1 = torch.empty_like(ps) if emit_v else None
    buf = _pass_sum(launch.mode, ng, dtype, dev)
    with torch.cuda.device(dev):
        err = fn(
            field_smoothed.data_ptr(), ps.data_ptr(), p0.data_ptr(),
            v0.data_ptr(), ph.data_ptr(), v1.data_ptr() if emit_v else None,
            buf.data_ptr(), n, ng, qm_dt, qm_dt2_half, dt_dx, wf, _inv(ng, dtype),
            SMEM_MODES[launch.mode], launch.blocks, launch.threads, launch.cluster,
            _stream(dev))
    _build.check(err, name)
    _count(name, launch.mode)
    jh = buf[-ng:]
    return (ph, v1, jh) if emit_v else (ph, jh)


def picard_finalize_nodep(field_smoothed, ps, p0, v0, ng: int, *, qm,
                          dt: float, dx: float):
    """Post-convergence sweep without the j1 deposit: final (p1, v1), p1
    wrapped."""
    kind, n = _check_pass("picard_finalize_nodep", field_smoothed, ps, p0, v0, ng)
    _check_ng(ng)
    if kind == "cpu":
        return picard_finalize_nodep_plain(field_smoothed, ps, p0, v0, ng,
                                           qm=qm, dt=dt, dx=dx)
    dev, dtype = ps.device, ps.dtype
    launch = _sweep(dev, "picard_finalize_nodep", n, ng, item=ps.element_size())
    fn, name = _launcher(_build.library(), "picard_finalize_nodep", dtype)
    qm_dt, qm_dt2_half, dt_dx, _ = kernel_scalars(qm, dt, dx, 0.0, dtype)
    p1 = torch.empty_like(ps)
    v1 = torch.empty_like(ps)
    with torch.cuda.device(dev):
        err = fn(
            field_smoothed.data_ptr(), ps.data_ptr(), p0.data_ptr(),
            v0.data_ptr(), p1.data_ptr(), v1.data_ptr(), n, ng, qm_dt,
            qm_dt2_half, dt_dx, _inv(ng, dtype), SMEM_MODES[launch.mode],
            launch.blocks, launch.threads, _stream(dev))
    _build.check(err, name)
    _count(name, launch.mode)
    return p1, v1


# (device, stream, blocks, ng, dtype) -> (partials, block counter): the
# scratch of the deterministic sums, kept across calls. The counter is
# zeroed once here; the last block of each launch sets it back to 0
# (det_flush and csrc/sheath.cu sheath_flush), and launches on one stream
# run in order, so a call allocates and fills nothing.
_DET_SCRATCH: dict = {}


def det_buffers(dev, blocks: int, ng: int, dtype: torch.dtype = torch.float32):
    """(per-block partials of ``dtype``, zeroed block counter) of a
    deterministic sum over ``blocks`` blocks of ng nodes, cached by device,
    stream, shape and dtype (a double kernel's partials are doubles). Call
    it with ``dev`` current."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, _stream(dev), blocks, ng, dtype)
    if key not in _DET_SCRATCH:
        _DET_SCRATCH[key] = (
            torch.empty((blocks * ng,), dtype=dtype, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    return _DET_SCRATCH[key]


def large_scratch(dev, blocks: int, ng: int, dtype: torch.dtype = torch.float32):
    """(per-block maxima, node sums) of a large deterministic sum
    (cic_common.cuh "Large deterministic sums"), written by the kernels
    before they read them, so nothing is zeroed or kept across calls:
    float32 maxima and ng int64 (4 blocks + 8 ng bytes), or for the
    double kernels double maxima and the two words of ng two-word fixed
    points, hi then lo (8 blocks + 16 ng bytes)."""
    words = 2 if dtype == torch.float64 else 1
    return (torch.empty((blocks,), dtype=dtype, device=dev),
            torch.empty((words * ng,), dtype=torch.int64, device=dev))


def deterministic_scratch(n: int, ng: int, dev, dtype: torch.dtype = torch.float32):
    """(launch shape, scratch a, scratch b) of the deterministic deposit:
    the sheath pass's grid without the field
    (``cuda_sheath.launch_shape(n, ng, sms, field=False, item=...)``:
    persistent blocks over contiguous row ranges), fixed by n, ng, the
    dtype and the card. Up to ng = 1,815 (float32; 907 float64) a column
    of ng elements a thread and the summed order of ``det_buffers``
    (per-block partials, zeroed block counter); above it the large mode's
    fixed-point sums in ``large_scratch`` (per-block maxima, node sums).
    Call it with ``dev`` current. Raises above LARGE_MAX_NG."""
    from .cuda_sheath import launch_shape

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    item = torch.finfo(dtype).bits // 8
    shape = launch_shape(max(n, 1), ng, _sm_count(index), field=False, item=item)
    if shape.large:
        return (shape, *large_scratch(dev, shape.blocks, ng, dtype))
    return (shape, *det_buffers(dev, shape.blocks, ng, dtype))


ROW_ALIGN = 4  # elements: 16 B of floats, 32 B of doubles


def padded_rows(k: int, n: int, device,
                dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, ...]:
    """``k`` (n,) outputs of ``dtype`` (the inputs') cut from one (k,
    pitch) buffer whose row pitch rounds n up to a multiple of 4
    elements: each view is contiguous and starts 16-B aligned, so the
    kernels that read them next take 16-B loads whatever n is."""
    pitch = -(-n // ROW_ALIGN) * ROW_ALIGN
    buf = torch.empty((k, pitch), dtype=dtype, device=device)
    return tuple(buf[r, :n] for r in range(k))


def deposit(p, values, ng: int, *, periodic: bool, cols: int = DEPOSIT_MAX_COLS):
    """CIC-deposit per-particle ``values`` at grid positions ``p`` onto ng
    nodes (values carry every prefactor; masked particles carry 0). On the
    card the grid is ``deposit_launch_shape(n, ng, False, sms, hists=1,
    max_cols=cols)`` (above 58,112 nodes its large mode, cols 0: every add
    a global float atomic) and a product of exactly 0 adds nothing
    (csrc/cic.cu).
    ``cols`` caps the wide grid's lane columns (a power of two up to 32):
    dense values want the most, whose adds then never share a word within a
    warp; a histogram whose weights are mostly 0 (``ops.cic.histogram_add``)
    wants 1, which spares zeroing and summing the others (PERF.md §6). It
    changes the order of the float sums only."""
    kind = _device_kind((p, values), "deposit")
    n = p.shape[0] if p.dim() == 1 else -1
    _check_1d("p", p, n)
    _check_1d("values", values, n)
    _check_ng(ng)
    if kind == "cpu":
        return deposit_plain(p, values, ng, periodic=periodic)
    fn, name = _launcher(_build.library(), "deposit", p.dtype)
    dev = p.device
    with torch.cuda.device(dev):
        shape = _deposit_shape(dev, n, ng, False, hists=1, max_cols=cols,
                               item=p.element_size())
        out = torch.zeros((ng,), dtype=p.dtype, device=dev)
        err = fn(p.data_ptr(), values.data_ptr(), out.data_ptr(), n, ng,
                 int(periodic), shape.rows, shape.blocks, shape.threads,
                 shape.cols, _stream(dev))
    _build.check(err, name)
    _count(name, shape.mode)
    return out


def deposit_det(p, values, ng: int, *, periodic: bool):
    """``deposit`` with the sums in a fixed order on the card (no float
    atomics), so that a call gives the same bits every time: up to ng =
    1,815 (float64: 907) a column a thread and cic_common.cuh det_flush's
    ordered sums, above it (up to LARGE_MAX_NG) fixed-point sums, exact
    and associative (csrc/cic.cu deposit_det_large_kernel: one int64 word
    a node in float32, two in float64). Float64 tensors launch the double
    kernel (counted as ``deposit_det_f64``); the output is in the inputs'
    dtype. CPU tensors take the plain deposit at any ng. The sheath
    engine's composed loop and exit histograms use it: its floor exit
    reads the residual at round-off level. The other engines keep the
    float-atomic ``deposit``."""
    kind = _device_kind((p, values), "deposit_det")
    n = p.shape[0] if p.dim() == 1 else -1
    _check_1d("p", p, n)
    _check_1d("values", values, n)
    _check_ng(ng)
    if kind == "cpu":
        return deposit_plain(p, values, ng, periodic=periodic)
    lib = _build.library()
    dev, dtype = p.device, p.dtype
    out = torch.empty((ng,), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        shape, a, b = deterministic_scratch(n, ng, dev, dtype)
        fn, name = _launcher(lib, "deposit_det", dtype, shape.large)
        err = fn(
            p.data_ptr(), values.data_ptr(), out.data_ptr(), a.data_ptr(),
            b.data_ptr(), n, ng, int(periodic), shape.blocks, shape.threads,
            shape.rows_per_block, _stream(dev))
    _build.check(err, name)
    LAUNCHES[name] += 1
    if shape.large:
        LARGE_LAUNCHES[f"{name} fixed"] += 1
    return out


def gather(field, p, *, periodic: bool):
    """CIC gather of the (ng,) node field at grid positions p: (n,)."""
    kind = _device_kind((field, p), "gather")
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    _check_1d("p", p, p.shape[0] if p.dim() == 1 else -1)
    _check_ng(ng)
    if kind == "cpu":
        return gather_plain(field, p, periodic=periodic)
    n = p.shape[0]
    dev = p.device
    launch = _sweep(dev, "gather", n, ng, item=p.element_size())
    fn, name = _launcher(_build.library(), "gather", p.dtype)
    out = torch.empty_like(p)
    with torch.cuda.device(dev):
        err = fn(field.data_ptr(), p.data_ptr(), out.data_ptr(), n, ng,
                 int(periodic), SMEM_MODES[launch.mode], launch.blocks,
                 launch.threads, _stream(dev))
    _build.check(err, name)
    _count(name, launch.mode)
    return out


def _check_leapfrog(name, field, p, v):
    kind = _device_kind((field, p, v), name)
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    n = p.shape[0] if p.dim() == 1 else -1
    _check_1d("p", p, n)
    _check_1d("v", v, n)
    return kind, n, ng


def leapfrog_gather_push_deposit(field, p, v, *, qm, w, dt: float, dx: float):
    """One sweep of the explicit cycle: gather the field at p, leapfrog,
    wrap, and deposit the charge density of the NEW positions. Returns
    (p1, v1, rho1). ``qm`` and ``w`` are the scalars q/m and q p2c / dx
    (rounded to the tensors' dtype by ``leapfrog_scalars``). On the card
    its mode is ``cluster_launch``'s (PASS_RULE)."""
    kind, n, ng = _check_leapfrog("leapfrog_gather_push_deposit", field, p, v)
    _check_ng(ng)
    if kind == "cpu":
        return leapfrog_gather_push_deposit_plain(field, p, v, qm=qm, w=w,
                                                  dt=dt, dx=dx)
    dev, dtype = p.device, p.dtype
    launch = _pass_launch(dev, "leapfrog_gather_push_deposit", n, ng, p.element_size(),
                          False)
    fn, name = _launcher(_build.library(), "leapfrog_gather_push_deposit", dtype,
                         entry="leapfrog_deposit")
    qmh, dt_dx, wf = leapfrog_scalars(qm, dt, dx, w, dtype)
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    buf = _pass_sum(launch.mode, ng, dtype, dev)
    with torch.cuda.device(dev):
        err = fn(field.data_ptr(), p.data_ptr(), v.data_ptr(), p1.data_ptr(),
                 v1.data_ptr(), buf.data_ptr(), n, ng, qmh, dt_dx, wf, _inv(ng, dtype),
                 SMEM_MODES[launch.mode], launch.blocks, launch.threads, launch.cluster,
                 _stream(dev))
    _build.check(err, name)
    _count(name, launch.mode)
    return p1, v1, buf[-ng:]


# shared memory of explicit_cycle: its field and histogram and ng + 32
# float64 (the solve's scan and reduction scratch), i.e. four ng-float
# arrays + 256 B, or in double three ng-double arrays + 256 B; beside
# them the epilogue's ticket, 16 static bytes (ptxas -v), which a block's
# SMEM_LIMIT holds too
_CYCLE_ARRAYS, _CYCLE_EXTRA = 4, 256
_CYCLE_ARRAYS_F64 = 3


def check_cycle_smem(ng: int, item: int = 4) -> None:
    """explicit_cycle's shared memory at ng for ``item``-byte elements
    (float32 4, float64 8), its ticket's static bytes counted: at most
    14,511 nodes in float32, 9,674 in float64."""
    arrays = _CYCLE_ARRAYS if item == 4 else _CYCLE_ARRAYS_F64
    _check_smem(ng, arrays, "explicit_cycle", _CYCLE_EXTRA + STATIC_INT_BYTES, item)


def explicit_cycle(e_field, p, v, ng: int, *, qm, w, dt: float, dx: float):
    """The whole explicit cycle in one launch: the leapfrog sweep and the
    solve of the deposited rho for the next step's field. Returns
    (p1, v1, rho1, e1).

    On the card the block keeps four ng-float arrays, 256 B and its
    ticket's 16 static bytes in shared memory, so it raises above ng =
    14,511 (a float64 state: three ng-double arrays, 9,674;
    ``check_cycle_smem``); the explicit engine calls it at ng <= 1,024
    only (the JAX engine's switch) and ``leapfrog_gather_push_deposit``
    with the solve outside above."""
    kind, n, _ = _check_leapfrog("explicit_cycle", e_field, p, v)
    _check_1d("e_field", e_field, ng)
    _check_ng(ng)
    if kind == "cpu":
        return explicit_cycle_plain(e_field, p, v, ng, qm=qm, w=w, dt=dt,
                                    dx=dx)
    dev, dtype = p.device, p.dtype
    check_cycle_smem(ng, p.element_size())
    fn, name = _launcher(_build.library(), "explicit_cycle", dtype)
    qmh, dt_dx, wf = leapfrog_scalars(qm, dt, dx, w, dtype)
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    # rho and, after it, the epilogue's block counter: one zeroed buffer of
    # the state's dtype (the counter the first word of its last element)
    buf = torch.zeros((ng + 1,), dtype=dtype, device=dev)
    e1 = torch.empty((ng,), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(e_field.data_ptr(), p.data_ptr(), v.data_ptr(), p1.data_ptr(),
                 v1.data_ptr(), buf.data_ptr(), e1.data_ptr(), n, ng, qmh, dt_dx,
                 wf, _inv(ng, dtype), _solve_coef(dx), _blocks(n, dev), _THREADS,
                 _stream(dev))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return p1, v1, buf[:ng], e1


RESIDENT_MAX_N = 32768  # pallas_cic._RESIDENT_MAX_N
RESIDENT_MAX_NG = 1024  # the engine's limit (ONE_KERNEL_MAX_NG)
# the launch of csrc/explicit.cu: ONE cluster of 8 CTAs of 512 threads,
# each CTA holding at most 4096 particles in registers (8 a thread), the
# deposit in 32 columns a node (one a lane)
RESIDENT_EXPLICIT_CLUSTER = 8
RESIDENT_EXPLICIT_THREADS = 512
RESIDENT_EXPLICIT_COLS = 32
RESIDENT_EXPLICIT_ROWS = RESIDENT_MAX_N // RESIDENT_EXPLICIT_CLUSTER


@dataclasses.dataclass(frozen=True)
class ExplicitResidentShape:
    """The launch of the resident explicit kernel for (n, ng): ``cluster``
    CTAs of ``threads`` threads; CTA r owns rows [r per_cta, (r + 1)
    per_cta) (clipped to n), thread t of it rows r per_cta + j threads + t
    for j < per_thread; ``smem`` bytes of shared memory a CTA."""
    cluster: int
    threads: int
    per_cta: int
    per_thread: int
    smem: int


def explicit_resident_shape(n: int, ng: int) -> ExplicitResidentShape:
    """The partition of n particles over the kernel's one cluster, a
    function of (n, ng) alone, and with it the order of its sums. Raises
    past n = 32,768 or ng = 1,024.

    Shared memory a CTA (the kernel's ``resident_smem``): the ke, jb
    partials rank 0 receives (three steps' worth: 6 float64 a warp of the
    cluster), three float64 a warp of the field solve's sums, two
    mbarriers, the deposit's columns (32 x ng float32), the received
    totals of two step parities (2 x 8 x ng) and the field (ng)."""
    if n > RESIDENT_MAX_N:
        raise ValueError(
            f"resident cycle requires n <= {RESIDENT_MAX_N} (got {n})")
    if ng > RESIDENT_MAX_NG:
        raise ValueError(
            f"resident cycle requires ng <= {RESIDENT_MAX_NG} (got {ng})")
    ctas, threads = RESIDENT_EXPLICIT_CLUSTER, RESIDENT_EXPLICIT_THREADS
    per_cta = -(-n // ctas)
    warps = threads // 32
    smem = (8 * (6 * ctas + 3) * warps + 16
            + 4 * (RESIDENT_EXPLICIT_COLS + 2 * ctas + 1) * ng)
    return ExplicitResidentShape(
        cluster=ctas, threads=threads, per_cta=per_cta,
        per_thread=-(-per_cta // threads), smem=smem)


def explicit_resident_rows(n: int, ng: int) -> np.ndarray:
    """(cluster, threads, slots) int array: the particle row each slot of
    each thread holds, -1 where it holds none (the kernel's map; slots =
    RESIDENT_EXPLICIT_ROWS / threads)."""
    shape = explicit_resident_shape(n, ng)
    r = np.arange(shape.cluster)[:, None, None]
    t = np.arange(shape.threads)[None, :, None]
    j = np.arange(RESIDENT_EXPLICIT_ROWS // shape.threads)[None, None, :]
    begin = r * shape.per_cta
    rows = begin + j * shape.threads + t
    end = np.minimum(begin + shape.per_cta, n)
    return np.where(rows < end, rows, -1)


def explicit_cycle_resident(e_field, p, v, ng: int, steps: int, *, qm, w,
                            ke_c: float, jb_c: float, dt: float, dx: float,
                            fe_c: float):
    """``steps`` explicit cycles in one launch with the population held on
    chip (n <= 32768). Returns (p1, v1, rho1, e1, fe, ke, jb), the last
    three (steps,) rows of the pre-push field energy fe_c sum(e^2), kinetic
    energy ke_c sum(v^2) and current bias jb_c sum(v).

    On the card the kernel runs as one cluster of 8 CTAs
    (``explicit_resident_shape``) and takes ng <= 1024."""
    kind, n, _ = _check_leapfrog("explicit_cycle_resident", e_field, p, v)
    _check_1d("e_field", e_field, ng)
    if n > RESIDENT_MAX_N:
        raise ValueError(
            f"resident cycle requires n <= {RESIDENT_MAX_N} (got {n})")
    if int(steps) < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    _check_ng(ng)
    if kind == "cpu":
        return explicit_cycle_resident_plain(
            e_field, p, v, ng, int(steps), qm=qm, w=w, ke_c=ke_c, jb_c=jb_c,
            dt=dt, dx=dx, fe_c=fe_c)
    shape = explicit_resident_shape(n, ng)
    lib = _build.library()
    qmh, dt_dx, wf = leapfrog_scalars(qm, dt, dx, w)
    dev = p.device
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    fields = torch.empty((2, ng), dtype=torch.float32, device=dev)
    rows = torch.empty((3, int(steps)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_explicit_resident(
            e_field.data_ptr(), p.data_ptr(), v.data_ptr(), p1.data_ptr(),
            v1.data_ptr(), fields[0].data_ptr(), fields[1].data_ptr(),
            rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(), n,
            shape.per_cta, ng, int(steps), qmh, dt_dx, wf, _inv(ng),
            _solve_coef(dx), float(fe_c), float(ke_c), float(jb_c),
            _stream(dev))
    _build.check(err, "explicit_cycle_resident")
    LAUNCHES["explicit_cycle_resident"] += 1
    return p1, v1, fields[0], fields[1], rows[0], rows[1], rows[2]


def picard_finalize(field_smoothed, ps, p0, v0, ng: int, *, qm, w, dt: float,
                    dx: float):
    """Post-convergence sweep with the full-step current: final (p1, v1),
    p1 wrapped, and j1 = the deposit of w v1 at p1. p1 and v1 are
    bit-identical to ``picard_finalize_nodep``'s."""
    kind, n = _check_pass("picard_finalize", field_smoothed, ps, p0, v0, ng)
    _check_ng(ng)
    if kind == "cpu":
        return picard_finalize_plain(field_smoothed, ps, p0, v0, ng, qm=qm,
                                     w=w, dt=dt, dx=dx)
    dev, dtype = ps.device, ps.dtype
    launch = _sweep(dev, "picard_finalize", n, ng, item=ps.element_size())
    fn, name = _launcher(_build.library(), "picard_finalize", dtype)
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w, dtype)
    p1 = torch.empty_like(ps)
    v1 = torch.empty_like(ps)
    j1 = torch.zeros((ng,), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            field_smoothed.data_ptr(), ps.data_ptr(), p0.data_ptr(),
            v0.data_ptr(), p1.data_ptr(), v1.data_ptr(), j1.data_ptr(), n, ng,
            qm_dt, qm_dt2_half, dt_dx, wf, _inv(ng, dtype),
            SMEM_MODES[launch.mode], launch.blocks, launch.threads, _stream(dev))
    _build.check(err, name)
    _count(name, launch.mode)
    return p1, v1, j1


def picard_iteration_shared(field_smoothed, ps, p0, v0, ng: int, *, qm, w,
                            dt: float, dx: float, emit_v: bool = False):
    """Shared-window Picard pass. Returns (ph, jh, n_clamped), or
    (ph, v1, jh, n_clamped) with ``emit_v``: as ``picard_iteration``, but
    the deposit of w vh lands at the midpoint as seen from the gather's
    window frame (``window_sw``), and ``n_clamped``, an int32 tensor on
    the particles' device, counts the deposits clamped at the frame's
    edge. With no clamp, jh equals a deposit at the wrapped ph up to
    rounding."""
    kind, n = _check_pass("picard_iteration_shared", field_smoothed, ps, p0, v0, ng)
    _check_ng(ng)
    if kind == "cpu":
        return picard_iteration_shared_plain(field_smoothed, ps, p0, v0, ng,
                                             qm=qm, w=w, dt=dt, dx=dx,
                                             emit_v=emit_v)
    dev, dtype = ps.device, ps.dtype
    launch = _pass_launch(dev, "picard_iteration_shared", n, ng, ps.element_size(),
                          emit_v)
    fn, name = _launcher(_build.library(), "picard_iteration_shared", dtype)
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w, dtype)
    stride, width, num_k, inv_stride = _shared_frame_args(ng, dtype)
    ph = torch.empty_like(ps)
    v1 = torch.empty_like(ps) if emit_v else None
    buf = _pass_sum(launch.mode, ng, dtype, dev)
    n_clamped = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            field_smoothed.data_ptr(), ps.data_ptr(), p0.data_ptr(),
            v0.data_ptr(), ph.data_ptr(), v1.data_ptr() if emit_v else None,
            buf.data_ptr(), n_clamped.data_ptr(), n, ng, qm_dt, qm_dt2_half,
            dt_dx, wf, _inv(ng, dtype), stride, width, num_k, inv_stride,
            SMEM_MODES[launch.mode], launch.blocks, launch.threads, launch.cluster,
            _stream(dev))
    _build.check(err, name)
    _count(name, launch.mode)
    jh = buf[-ng:]
    return (ph, v1, jh, n_clamped) if emit_v else (ph, jh, n_clamped)


RESIDENT_MAX_N_IMPLICIT = 131072  # pallas_cic._RESIDENT_MAX_N_IMPLICIT
RESIDENT_MAX_NG_IMPLICIT = 1024  # the engine's limit; one node a thread
# the launch of csrc/implicit.cu: ONE cluster of 16 CTAs x 1024 threads,
# each thread holding at most 8 particles
RESIDENT_IMPLICIT_CLUSTER = 16
RESIDENT_IMPLICIT_THREADS = 1024
RESIDENT_IMPLICIT_SLOTS = 8
# shared memory: 2,240 float64 of reduction and metric partials, the
# deposit's columns (cols x ng float32), 41 float32 a node (two parities
# of the 16 CTAs' totals, and the node's record of e0/e1, eh, jh, the
# sweep's field, the next step's first field, es and the Anderson
# residual: 9) and the particles' v0 (SLOTS x THREADS float32)
_IMPLICIT_DOUBLES, _IMPLICIT_ARRAYS = 2240, 41


@dataclasses.dataclass(frozen=True)
class ResidentShape:
    """The launch of the resident implicit kernel for (n, ng): ``cluster``
    CTAs of ``threads`` threads; CTA r owns rows [r per_cta, (r + 1)
    per_cta) (clipped to n), thread t of it rows r per_cta + j threads + t
    for j < per_thread; the deposit goes to ``cols`` columns a node;
    ``smem`` bytes of shared memory a CTA."""
    cluster: int
    threads: int
    per_cta: int
    per_thread: int
    cols: int
    smem: int


def implicit_resident_shape(n: int, ng: int) -> ResidentShape:
    """The partition of n particles over the kernel's one cluster, a
    function of (n, ng) alone, and with it the order of its sums. Raises
    past n = 131,072 or ng = 1,024."""
    if n > RESIDENT_MAX_N_IMPLICIT:
        raise ValueError(
            f"resident implicit requires n <= {RESIDENT_MAX_N_IMPLICIT}")
    if ng > RESIDENT_MAX_NG_IMPLICIT:
        raise ValueError(
            f"resident implicit requires ng <= {RESIDENT_MAX_NG_IMPLICIT} "
            f"(got {ng})")
    per_cta = -(-n // RESIDENT_IMPLICIT_CLUSTER)

    def smem(cols: int) -> int:
        return 8 * _IMPLICIT_DOUBLES + 4 * (
            (cols + _IMPLICIT_ARRAYS) * ng
            + RESIDENT_IMPLICIT_SLOTS * RESIDENT_IMPLICIT_THREADS)

    # a lane a column up to ng = 256 (a warp's deposits hit 32 banks), 8
    # above, halved until the block's shared memory holds them (2 at 1024)
    cols = 32 if ng <= 256 else 8
    while smem(cols) > SMEM_LIMIT:
        cols //= 2
    return ResidentShape(
        cluster=RESIDENT_IMPLICIT_CLUSTER, threads=RESIDENT_IMPLICIT_THREADS,
        per_cta=per_cta, per_thread=-(-per_cta // RESIDENT_IMPLICIT_THREADS),
        cols=cols, smem=smem(cols))


def implicit_resident_rows(n: int, ng: int) -> np.ndarray:
    """(cluster, threads, SLOTS) int array: the particle row each slot of
    each thread holds, -1 where it holds none (the kernel's map)."""
    shape = implicit_resident_shape(n, ng)
    r = np.arange(shape.cluster)[:, None, None]
    t = np.arange(shape.threads)[None, :, None]
    j = np.arange(RESIDENT_IMPLICIT_SLOTS)[None, None, :]
    begin = r * shape.per_cta
    rows = begin + j * shape.threads + t
    end = np.minimum(begin + shape.per_cta, n)
    return np.where(rows < end, rows, -1)


@functools.lru_cache(maxsize=None)
def _resident_clusters(index: int, ng: int) -> int:
    """Clusters of the resident kernel's shape card ``index`` holds at once
    (cudaOccupancyMaxActiveClusters); raises if it cannot hold one."""
    shape = implicit_resident_shape(1, ng)
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.library().pypic_implicit_resident_clusters(
            ng, shape.cols, ctypes.byref(count))
    _build.check(err, "implicit_resident (cluster occupancy)")
    if count.value < 1:
        raise RuntimeError(
            f"implicit_resident: {torch.cuda.get_device_name(index)} cannot "
            f"hold one cluster of {shape.cluster} CTAs x {shape.threads} "
            f"threads with {shape.smem} B of shared memory each "
            "(cudaOccupancyMaxActiveClusters = 0); the kernel needs 16 SMs "
            "of one GPC free")
    return count.value


def implicit_resident(e0, e_prev, j0, p, v, ng: int, steps: int, *, qm, w,
                      ke_c: float, dt: float, dx: float, tol: float,
                      maxiter: int, extrapolate: bool, anderson: bool,
                      fe_c: float, tracer: int, smooth: bool = True):
    """``steps`` implicit CN-Picard steps in one launch (the fused step
    with finalize='converged', finalize_field='last', separate windows),
    n <= 131072. ``e0``, ``e_prev`` and ``j0`` are the state's field,
    previous field and current; ``qm`` and ``w`` the float32 scalars q/m
    and q p2c / dx; ``ke_c`` = p2c m / 2 and ``fe_c`` = eps0 dx / 2.

    Returns (p1, v1, e1, e_prev1, jh, rows): the last step's field, the
    field before it and its half-step current, and a dict of (steps,) rows
    fe, ke, jb (field and kinetic energy, current bias after each step),
    iters (int32), resid, tracer_x and tracer_v.

    On the card the kernel runs as one cluster of 16 CTAs
    (``implicit_resident_shape``) and takes ng <= 1024; it raises if the
    card cannot hold the cluster."""
    kind = _device_kind((e0, e_prev, j0, p, v), "implicit_resident")
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in (("e0", e0), ("e_prev", e_prev), ("j0", j0)):
        _check_1d(name, t, ng)
    _check_1d("p", p, n)
    _check_1d("v", v, n)
    if n > RESIDENT_MAX_N_IMPLICIT:
        raise ValueError(
            f"resident implicit requires n <= {RESIDENT_MAX_N_IMPLICIT}")
    if int(steps) < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    _check_ng(ng)
    kw = dict(qm=qm, w=w, ke_c=ke_c, dt=dt, dx=dx, tol=tol, maxiter=maxiter,
              extrapolate=extrapolate, anderson=anderson, fe_c=fe_c,
              tracer=tracer, smooth=smooth)
    if kind == "cpu":
        return implicit_resident_plain(e0, e_prev, j0, p, v, ng, int(steps),
                                       **kw)
    shape = implicit_resident_shape(n, ng)
    dev = p.device
    _resident_clusters(dev.index if dev.index is not None
                       else torch.cuda.current_device(), ng)
    lib = _build.library()
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w)
    s = int(steps)
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    fields = torch.empty((3, ng), dtype=torch.float32, device=dev)
    rows = torch.zeros((6, s), dtype=torch.float32, device=dev)
    iters = torch.zeros((s,), dtype=torch.int32, device=dev)
    jb_c = float(np.float32(wf) / np.float32(ng))
    with torch.cuda.device(dev):
        err = lib.pypic_implicit_resident(
            e0.data_ptr(), e_prev.data_ptr(), j0.data_ptr(), p.data_ptr(),
            v.data_ptr(), p1.data_ptr(), v1.data_ptr(),
            fields[0].data_ptr(), fields[1].data_ptr(), fields[2].data_ptr(),
            rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
            iters.data_ptr(), rows[3].data_ptr(), rows[4].data_ptr(),
            rows[5].data_ptr(), n, shape.per_cta, ng, shape.cols, s, qm_dt,
            qm_dt2_half, dt_dx, wf, _inv(ng), float(np.float32(dt / EPSILON_0)),
            float(np.float32(tol)), int(maxiter), int(bool(extrapolate)),
            int(bool(anderson)), int(bool(smooth)), int(tracer),
            float(fe_c), float(ke_c), jb_c, _stream(dev))
    _build.check(err, "implicit_resident")
    LAUNCHES["implicit_resident"] += 1
    return p1, v1, fields[0], fields[1], fields[2], dict(
        fe=rows[0], ke=rows[1], jb=rows[2], iters=iters, resid=rows[3],
        tracer_x=rows[4], tracer_v=rows[5])


# ---------------------------------------------------------------------------
# the magnetized engine's particle kernels
# ---------------------------------------------------------------------------

# the launch of the wide deposits (csrc/cic.cu deposit_kernel, csrc/magnetized.cu
# deposit2_kernel and boris_deposit_kernel; cic_common.cuh): wide, one
# block of DEPOSIT_WIDE_THREADS an SM, four rows a thread and pass, each
# histogram in up to DEPOSIT_MAX_COLS lane columns; narrow (fewer rows than
# give every such thread four), the first port's grid: DEPOSIT_NARROW_THREADS
# threads, a row a thread, up to _BLOCKS_PER_SM blocks an SM, one column
DEPOSIT_WIDE_THREADS = 1024
DEPOSIT_NARROW_THREADS = _THREADS
_DEPOSIT_NAMES = {(1, False): "deposit", (2, False): "deposit2",
                  (2, True): "boris_gather_push_deposit"}
# the static shared bytes of their kernels (the carried Boris deposit's
# clamp count)
DEPOSIT_STATIC = {"deposit": 0, "deposit2": 0,
                  "boris_gather_push_deposit": STATIC_INT_BYTES}


@dataclasses.dataclass(frozen=True)
class DepositShape:
    """The launch of ``deposit`` (one histogram), ``deposit2`` (two) or
    ``boris_gather_push_deposit`` (two and the field): ``blocks`` blocks of
    ``threads`` threads, ``rows`` rows a thread and pass (4 with 16-B
    accesses, or 1); block b sweeps the units of ``rows`` rows [b U / B,
    (b + 1) U / B), U = ceil(n / rows), B = blocks; each histogram has
    ``cols`` lane columns a node (0: the large mode, no shared histogram);
    ``smem`` bytes of dynamic shared memory a block (the columns, and the
    field for row 9); ``mode`` 'shared' (the columns), 'field' (the
    carried Boris deposit's large mode up to FIELD_SMEM_MAX_NG: the field
    alone in shared memory) or 'global' (nothing in shared memory)."""
    rows: int
    blocks: int
    threads: int
    cols: int
    smem: int
    mode: str = "shared"


def deposit_launch_shape(n: int, ng: int, field: bool, sms: int,
                         hists: int = 2, max_cols: int = DEPOSIT_MAX_COLS,
                         item: int = 4) -> DepositShape:
    """The grid of the wide deposits for n rows and ng nodes on a card of
    ``sms`` SMs, a function of these alone: ``hists`` histograms (1 for
    ``deposit``, 2 for ``deposit2`` and, with ``field``, the carried Boris
    deposit). Wide where every thread of one 1,024-thread block an SM gets
    a group of four rows: one such block an SM, ``max_cols`` (32) lane
    columns, halved until shared memory holds them beside the kernel's
    static bytes (DEPOSIT_STATIC). Narrow below that: the first port's
    grid, a row a thread, no more blocks than the rows fill. Where one
    column does not fit (``smem_mode``: above ng = 58,112 for ``deposit``,
    29,056 for deposit2, 19,369 with the field) the deposit takes the
    large mode: the same rows a block, ``cols`` 0 (no shared histogram,
    every add a global atomic), ``smem`` the field's where it fits alone
    (ng <= FIELD_SMEM_MAX_NG), else 0; it raises above LARGE_MAX_NG.
    ``item`` 8: the double deposits of a float64 state, whose columns and
    field take twice the bytes (one column fits to 29,056 nodes for
    ``deposit``, 14,528 for deposit2, 9,684 with the field; the field
    alone to ``field_smem_max_ng(8)`` = 28,928)."""
    if (n < 0 or ng < 2 or sms < 1 or (hists, field) not in _DEPOSIT_NAMES
            or max_cols not in (1, 2, 4, 8, 16, 32)):
        raise ValueError(f"deposit_launch_shape needs n >= 0, ng >= 2, sms >= 1, "
                         f"1 or 2 histograms (2 with the field) and max_cols a power "
                         f"of two up to 32; got {n}, {ng}, {sms}, {hists}, {max_cols}")
    if item not in (4, 8):
        raise ValueError(f"deposit_launch_shape: item {item} (4, or 8 for the "
                         "double kernels)")
    name = _DEPOSIT_NAMES[(hists, field)]
    static = DEPOSIT_STATIC[name]
    mode = smem_mode(ng, hists + int(field), static=static, what=name, item=item)
    if mode == "global" and field and ng <= field_smem_max_ng(item):
        mode = "field"

    def smem(cols: int) -> int:
        if mode != "shared":
            return item * ng if mode == "field" else 0
        return item * (hists * cols + int(field)) * ng

    if n >= 4 * DEPOSIT_WIDE_THREADS * sms:
        cols = max_cols if mode == "shared" else 0
        while smem(cols) + static > SMEM_LIMIT:
            cols //= 2
        return DepositShape(4, sms, DEPOSIT_WIDE_THREADS, cols, smem(cols), mode)
    blocks = max(1, min(-(-n // DEPOSIT_NARROW_THREADS), _BLOCKS_PER_SM * sms))
    cols = 1 if mode == "shared" else 0
    return DepositShape(1, blocks, DEPOSIT_NARROW_THREADS, cols, smem(cols), mode)


def deposit_row_blocks(n: int, ng: int, field: bool, sms: int,
                       hists: int = 2) -> np.ndarray:
    """(n,) int array: the block of ``deposit_launch_shape``'s grid that
    sweeps each row. Wide, block b the groups of four [b G / B, (b + 1) G /
    B), G = ceil(n / 4), B = blocks (the kernels' block_groups); narrow,
    the first port's grid stride: row i in block (i // threads) mod B."""
    shape = deposit_launch_shape(n, ng, field, sms, hists)
    i = np.arange(n, dtype=np.int64)
    if shape.rows == 1:
        return (i // shape.threads) % shape.blocks
    groups = -(-n // 4)
    # the last block b whose first group b G // B is at or below the row's
    first = np.arange(shape.blocks, dtype=np.int64) * groups // shape.blocks
    return np.searchsorted(first, i // 4, side="right") - 1


def _deposit_shape(dev, n: int, ng: int, field: bool, hists: int = 2,
                   max_cols: int = DEPOSIT_MAX_COLS, item: int = 4) -> DepositShape:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return deposit_launch_shape(n, ng, field, _sm_count(index), hists, max_cols, item)


def deposit2_plain(p, va, vb, ng: int, *, periodic: bool):
    """Two CIC deposits at the same positions, the indices and weights
    computed once (pallas_cic.py deposit2_pallas)."""
    num_cells = ng if periodic else ng - 1
    il, ir, wl, wr = cic_indices_weights(p, num_cells, periodic)
    out = []
    for values in (va, vb):
        acc = torch.zeros((ng,), dtype=values.dtype, device=values.device)
        acc.index_add_(0, il, values * wl)
        acc.index_add_(0, ir, values * wr)
        out.append(acc)
    return out[0], out[1]


def deposit2(p, va, vb, ng: int, *, periodic: bool):
    """Deposit ``va`` and ``vb`` (every prefactor included, 0 for masked
    particles) at grid positions p onto ng nodes in one sweep. Returns
    (a, b) in the inputs' dtype (float64: the double kernel, counted as
    ``deposit2_f64``). Positions off the grid (wall-lost slots, weight 0)
    are clamped into it as ``ops.cic.cic_indices_weights`` clamps them."""
    kind = _device_kind((p, va, vb), "deposit2")
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in (("p", p), ("va", va), ("vb", vb)):
        _check_1d(name, t, n)
    _check_ng(ng)
    if kind == "cpu":
        return deposit2_plain(p, va, vb, ng, periodic=periodic)
    fn, name = _launcher(_build.library(), "deposit2", p.dtype)
    dev = p.device
    out = torch.zeros((2, ng), dtype=p.dtype, device=dev)
    with torch.cuda.device(dev):
        shape = _deposit_shape(dev, n, ng, False, item=p.element_size())
        err = fn(p.data_ptr(), va.data_ptr(), vb.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), n, ng, int(periodic), shape.rows, shape.blocks,
                 shape.threads, shape.cols, _stream(dev))
    _build.check(err, name)
    _count(name, shape.mode)
    return out[0], out[1]


def boris_scalars(b, dt_dx: float, dtype: torch.dtype = torch.float32):
    """(bx, by, bz, dt/dx), each a Python float holding the value of
    ``dtype`` the TPU kernel bakes in (Python floats, weakly typed, round
    to the state's dtype at their first operation)."""
    f = real(dtype)
    return tuple(float(f(x)) for x in (*b, dt_dx))


def boris_gather_push_plain(field, p, vx, vy, vz, const, act, *, b,
                            dt_dx: float, swap_weights: bool = False):
    """The fused kernel's arithmetic as tensor operations
    (pallas_cic.py _boris_kernel): the bounded gather at
    clip(p, 0, ng - 1), or at its cell mirror with ``swap_weights``; the
    Boris rotation with inv = 2 / (1 + t^2), s = t inv; p1 = p + vx dt/dx.
    Rows with act == 0 keep their inputs."""
    ng = field.shape[0]
    bx, by, bz, dt_dx = boris_scalars(b, dt_dx, p.dtype)
    hi = float(ng - 1)
    pc = torch.clamp(p, 0.0, hi)
    if swap_weights:
        pc = torch.clamp(2.0 * torch.floor(pc) + 1.0 - pc, 0.0, hi)
    ex = gather_plain(field, pc, periodic=False)
    vx1 = vx + const * ex
    tx = const * bx
    ty = const * by
    tz = const * bz
    t2 = tx * tx + ty * ty + tz * tz
    # a true division, as the kernel's (a Python number over a tensor is
    # a reciprocal times the number in PyTorch: two roundings)
    inv = torch.full_like(t2, 2.0) / (1.0 + t2)
    sx = tx * inv
    sy = ty * inv
    sz = tz * inv
    vfx = vx1 + vy * tz - vz * ty
    vfy = vy + vz * tx - vx1 * tz
    vfz = vz + vx1 * ty - vy * tx
    vx1 = vx1 + (vfy * sz - vfz * sy)
    vy1 = vy + (vfz * sx - vfx * sz)
    vz1 = vz + (vfx * sy - vfy * sx)
    vx1 = vx1 + const * ex
    live = act > 0
    return (torch.where(live, p + vx1 * dt_dx, p), torch.where(live, vx1, vx),
            torch.where(live, vy1, vy), torch.where(live, vz1, vz))


def boris_gather_push(field, p, vx, vy, vz, const, act, *, b, dt_dx: float,
                      swap_weights: bool = False):
    """Fused bounded CIC gather of E_x + Boris-Buneman push, one sweep.

    Args:
        field: (ng,) E_x on the bounded grid.
        p: (n,) positions in grid coordinates.
        vx, vy, vz: (n,) velocity components [m/s].
        const: (n,) 0.5 dt e charge_state / m.
        act: (n,) 1.0 for active particles, 0.0 to hold their state.
        b: (bx, by, bz) [T]; dt_dx: dt / dx.
        swap_weights: gather at the cell-mirrored position (the
            reference's swapped intra-cell weights).

    Returns (p1, vx1, vy1, vz1) in the inputs' dtype (float64: the double
    kernel, its scalars in float64, counted as ``boris_gather_push_f64``).
    """
    arrays = (p, vx, vy, vz, const, act)
    kind = _device_kind((field,) + arrays, "boris_gather_push")
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in zip(("p", "vx", "vy", "vz", "const", "act"), arrays):
        _check_1d(name, t, n)
    _check_ng(ng)
    if kind == "cpu":
        return boris_gather_push_plain(field, p, vx, vy, vz, const, act, b=b,
                                       dt_dx=dt_dx, swap_weights=swap_weights)
    dev, dtype = p.device, p.dtype
    launch = _sweep(dev, "boris_gather_push", n, ng, item=p.element_size())
    fn, name = _launcher(_build.library(), "boris_gather_push", dtype)
    bx, by, bz, dt_dx_k = boris_scalars(b, dt_dx, dtype)
    out = torch.empty((4, n), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            field.data_ptr(), p.data_ptr(), vx.data_ptr(), vy.data_ptr(),
            vz.data_ptr(), const.data_ptr(), act.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(), n, ng,
            bx, by, bz, dt_dx_k, int(bool(swap_weights)),
            SMEM_MODES[launch.mode], launch.blocks, launch.threads,
            _stream(dev))
    _build.check(err, name)
    _count(name, launch.mode)
    return out[0], out[1], out[2], out[3]


def window(ng: int) -> tuple[int, int]:
    """(stride, width) of the TPU kernels' window frame, the cost rule of
    ``pallas_cic._choose_window`` copied: minimize 3 width + K over the
    widths the TPU kernel tiles, stride = width - 2, K = (ng - 1) //
    stride + 1 windows.

    The rule has no cost meaning on the GPU. It exists here because the
    carried deposit of ``boris_gather_push_deposit`` sees its new position
    from the gather's window, widened by ``pad`` rows: the frame decides
    which deposits clamp (``carry_clamped``) and where a clamped tent
    lands (ng 600 -> (14, 16), ng 64 -> (6, 8))."""
    return _tpu_frame(ng, margin=2, k_weight=1)


def _carry_frame(ng: int, dtype: torch.dtype = torch.float32):
    """(stride, K, 1/stride in ``dtype``) of ``window(ng)``."""
    stride, _ = window(ng)
    return stride, (ng - 1) // stride + 1, float(real(dtype)(1.0 / stride))


def boris_gather_push_deposit_plain(field, p, vx, vy, vz, const, act, wr, wn,
                                    *, b, dt_dx: float, pad: int = 2,
                                    swap_weights: bool = False,
                                    acc_dtype=None):
    """The fused kernel's arithmetic as tensor operations
    (pallas_cic.py _boris_deposit_kernel): ``boris_gather_push_plain``,
    then wr and wn deposited at p1 for rows with p1 in [0, ng - 1], at the
    row d_h = (pc - stride k) + (p1 - pc) + pad of the gather's window k,
    clamped to [0, wp - 1] (counted where wn > 0). ``acc_dtype`` is the
    dtype rho and n are summed in (float32 by default): float64 sums the
    same float32 terms into a reference for the kernel's sums."""
    ng = field.shape[0]
    p1, vx1, vy1, vz1 = boris_gather_push_plain(
        field, p, vx, vy, vz, const, act, b=b, dt_dx=dt_dx,
        swap_weights=swap_weights)
    hi = float(ng - 1)
    pc = torch.clamp(p, 0.0, hi)
    if swap_weights:
        pc = torch.clamp(2.0 * torch.floor(pc) + 1.0 - pc, 0.0, hi)
    stride, num_k, inv_stride = _carry_frame(ng, p.dtype)
    top = float(stride + 2 + 2 * pad - 1)
    live = (p1 >= 0.0) & (p1 <= hi)
    wr = torch.where(live, wr, 0.0)
    wn = torch.where(live, wn, 0.0)
    k = torch.clamp((torch.floor(pc) * inv_stride).to(torch.int32), 0, num_k - 1)
    d_h = ((pc - (k * stride).to(pc.dtype)) + (p1 - pc)) + float(pad)
    n_clamped = (((d_h < 0.0) | (d_h > top)) & (wn > 0.0)).sum(dtype=torch.int32)
    d_h = torch.clamp(d_h, 0.0, top)
    row = torch.floor(d_h)
    fr = d_h - row
    node = (k * stride - pad).to(torch.int64) + row.to(torch.int64)
    acc = acc_dtype or wr.dtype
    out = []
    for values in (wr, wn):
        dep = torch.zeros((ng,), dtype=acc, device=values.device)
        for idx, wt in ((node, 1.0 - fr), (node + 1, fr)):
            inside = (idx >= 0) & (idx < ng)
            dep.index_add_(0, torch.clamp(idx, 0, ng - 1),
                           torch.where(inside, values * wt, 0.0).to(acc))
        out.append(dep)
    return p1, vx1, vy1, vz1, out[0], out[1], n_clamped


def boris_gather_push_deposit(field, p, vx, vy, vz, const, act, wr, wn, *, b,
                              dt_dx: float, pad: int = 2,
                              swap_weights: bool = False):
    """``boris_gather_push`` and the carried deposit of the next step in
    one sweep (carried_deposit='on').

    ``wr`` and ``wn`` are the (n,) rho and number-density weights of the
    next step (every prefactor included, 0 in inactive slots); they are
    deposited at p1 for rows whose p1 lies in [0, ng - 1] (this step's
    wall hits deposit nothing), each seen from the gather's window
    (``window``) widened by ``pad`` rows a side: a deposit past that edge
    clamps to it and, where wn > 0, is counted.

    Returns (p1, vx1, vy1, vz1, rho, n_dens, n_clamped), n_clamped an
    int32 0-d tensor on the particles' device, the rest in the inputs'
    dtype (float64: the double kernel, its window frame and clamps taken
    from the float64 positions, counted as
    ``boris_gather_push_deposit_f64``).
    """
    arrays = (p, vx, vy, vz, const, act, wr, wn)
    kind = _device_kind((field,) + arrays, "boris_gather_push_deposit")
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in zip(("p", "vx", "vy", "vz", "const", "act", "wr", "wn"),
                       arrays):
        _check_1d(name, t, n)
    _check_ng(ng)
    if pad < 0:
        raise ValueError(f"pad must be >= 0, got {pad}")
    if kind == "cpu":
        return boris_gather_push_deposit_plain(
            field, p, vx, vy, vz, const, act, wr, wn, b=b, dt_dx=dt_dx,
            pad=pad, swap_weights=swap_weights)
    dev, dtype = p.device, p.dtype
    fn, name = _launcher(_build.library(), "boris_gather_push_deposit", dtype)
    bx, by, bz, dt_dx_k = boris_scalars(b, dt_dx, dtype)
    stride, num_k, inv_stride = _carry_frame(ng, dtype)
    out = padded_rows(4, n, dev, dtype)
    dens = torch.zeros((2, ng), dtype=dtype, device=dev)
    n_clamped = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        shape = _deposit_shape(dev, n, ng, True, item=p.element_size())
        err = fn(
            field.data_ptr(), *(t.data_ptr() for t in arrays),
            *(o.data_ptr() for o in out), dens[0].data_ptr(),
            dens[1].data_ptr(), n_clamped.data_ptr(), n, ng, bx, by, bz,
            dt_dx_k, int(bool(swap_weights)), stride, num_k, inv_stride,
            int(pad), shape.rows, shape.blocks, shape.threads, shape.cols,
            _stream(dev))
    _build.check(err, name)
    _count(name, shape.mode)
    return out[0], out[1], out[2], out[3], dens[0], dens[1], n_clamped
