"""Build and load the package's CUDA kernels.

The sources under ``pypic_tpu_torch/csrc/`` have a plain C interface. Each
``*.cu`` is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all
started together, and the objects are linked into one shared library,
loaded with ``ctypes``: no PyTorch headers, no ``cpp_extension``. The
library goes into ``pypic_tpu_torch/_build/`` (not committed) under a name
keyed by a hash of the sources (``*.cu`` and ``*.cuh``) and flags, so an
edited source rebuilds.

The build runs at the first launch of a CUDA kernel wrapper, never at
import. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: floorf, the reciprocal-multiply wrap and the kernel
# scalars must round like the reference. -Xptxas -v reports registers and
# shared memory per kernel in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
_U = ctypes.c_uint

# extern "C" launchers in csrc/*.cu and their argument types.
_SIGNATURES = {
    # (the grid-stride kernels take their mode, ops/cuda_cic.py smem_mode,
    # before the grid)
    # (the Picard pass, rows 1 and 2, takes the CTAs a cluster of its
    # cluster mode after them, ops/cuda_cic.py cluster_launch)
    "pypic_picard_iteration": (
        [_P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _F, _I, _I, _I,
         _I, _P], _I),
    "pypic_picard_iteration_clusters": ([_I] * 6 + [_P], _I),
    "pypic_picard_finalize_nodep": (
        [_P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _I, _I, _I, _P], _I),
    "pypic_picard_finalize": (
        [_P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _F, _I, _I, _I,
         _P], _I),
    "pypic_picard_iteration_shared": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _F, _I, _I,
         _I, _F, _I, _I, _I, _I, _P], _I),
    # the double kernels of a float64 state (rows 1-6): every scalar a
    # double, _D, never _F (which would round it to float32 on the way)
    "pypic_picard_iteration_f64": (
        [_P] * 7 + [_L, _I] + [_D] * 5 + [_I, _I, _I, _I, _P], _I),
    "pypic_picard_finalize_nodep_f64": (
        [_P] * 6 + [_L, _I] + [_D] * 4 + [_I, _I, _I, _P], _I),
    "pypic_picard_finalize_f64": (
        [_P] * 7 + [_L, _I] + [_D] * 5 + [_I, _I, _I, _P], _I),
    "pypic_picard_iteration_shared_f64": (
        [_P] * 8 + [_L, _I] + [_D] * 5 + [_I, _I, _I, _D, _I, _I, _I, _I, _P], _I),
    "pypic_deposit_f64": ([_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P], _I),
    "pypic_gather_f64": ([_P, _P, _P, _L, _I, _I, _I, _I, _I, _P], _I),
    "pypic_implicit_resident": (
        [_P] * 17 + [_I] * 5 + [_F] * 7 + [_I] * 5 + [_D, _D, _D, _P], _I),
    "pypic_implicit_resident_clusters": ([_I, _I, _P], _I),
    "pypic_deposit": ([_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P], _I),
    "pypic_gather": ([_P, _P, _P, _L, _I, _I, _I, _I, _I, _P], _I),
    # (rows 14 and 17 take the CTAs a cluster after the threads too, and
    # have their occupancy queries: ops/cuda_cic.py cluster_launch)
    "pypic_leapfrog_deposit": (
        [_P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _I, _I, _I, _I, _P], _I),
    "pypic_leapfrog_deposit_clusters": ([_I] * 4 + [_P], _I),
    "pypic_explicit_cycle": (
        [_P, _P, _P, _P, _P, _P, _P, _L, _I, _F, _F, _F, _F, _D, _I, _I, _P],
        _I),
    "pypic_explicit_resident": (
        [_P] * 10 + [_I] * 4 + [_F] * 4 + [_D] * 4 + [_P], _I),
    "pypic_explicit_resident_smem": ([_I], _L),
    "pypic_deposit2": ([_P] * 5 + [_L, _I, _I, _I, _I, _I, _I, _P], _I),
    "pypic_boris_gather_push": (
        [_P] * 11 + [_L, _I, _F, _F, _F, _F, _I, _I, _I, _I, _P], _I),
    "pypic_boltzmann_dirichlet": (
        [_P] * 6 + [_I, _I] + [_F] * 5 + [_I, _F, _F, _P], _I),
    "pypic_boltzmann_dn": (
        [_P] * 6 + [_I, _I] + [_F] * 4 + [_I, _F, _F, _P], _I),
    "pypic_tridiag3_chain": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "pypic_boltzmann_dirichlet_large": (
        [_P] * 7 + [_I] * 3 + [_F] * 5 + [_I, _F, _F, _P], _I),
    "pypic_boltzmann_dn_large": (
        [_P] * 7 + [_I] * 3 + [_F] * 4 + [_I, _F, _F, _P], _I),
    "pypic_tridiag3_chain_large": ([_P] * 7 + [_I] * 5 + [_P], _I),
    # the Newton large path's cluster mode (ops/cuda_newton.py large_shape):
    # the large path's arguments with the CTAs a cluster and the shared
    # flag after the threads; its shared bytes and occupancy query
    "pypic_boltzmann_dirichlet_cluster": (
        [_P] * 7 + [_I] * 5 + [_F] * 5 + [_I, _F, _F, _P], _I),
    "pypic_boltzmann_dn_cluster": (
        [_P] * 7 + [_I] * 5 + [_F] * 4 + [_I, _F, _F, _P], _I),
    "pypic_boltzmann_dirichlet_cluster_f64": (
        [_P] * 7 + [_I] * 5 + [_D] * 5 + [_I, _D, _D, _P], _I),
    "pypic_boltzmann_dn_cluster_f64": (
        [_P] * 7 + [_I] * 5 + [_D] * 4 + [_I, _D, _D, _P], _I),
    "pypic_newton_cluster_smem": ([_I] * 6, _L),
    "pypic_newton_clusters": ([_I] * 6 + [_P], _I),
    "pypic_philox_uniforms": ([_P, _L, _I, _U, _U, _U, _U, _I, _I, _P], _I),
    "pypic_hash_batch": ([_P, _L, _I, _U, _U, _F, _I, _I, _I, _P], _I),
    "pypic_source_batch": (
        [_P] * 4 + [_L, _U, _U, _U] + [_F] * 7 + [_I, _I, _I, _P], _I),
    "pypic_source_blocks_per_sm": ([_I, _I], _I),
    "pypic_sheath_picard": (
        [_P] * 12 + [_L, _I] + [_F] * 4 + [_I, _I, _L, _P], _I),
    "pypic_sheath_finalize": (
        [_P] * 13 + [_L, _I] + [_F] * 4 + [_I, _I, _L, _P], _I),
    "pypic_deposit_det": ([_P] * 5 + [_L, _I, _I, _I, _I, _L, _P], _I),
    "pypic_sheath_picard_large": (
        [_P] * 12 + [_L, _I] + [_F] * 4 + [_I, _I, _L, _P], _I),
    "pypic_sheath_finalize_large": (
        [_P] * 13 + [_L, _I] + [_F] * 4 + [_I, _I, _L, _P], _I),
    "pypic_deposit_det_large": ([_P] * 5 + [_L, _I, _I, _I, _I, _L, _P], _I),
    "pypic_sheath_reinject": (
        [_P] * 12 + [_L, _U, _U, _U, _U, _F, _F, _F, _I, _I, _I, _P], _I),
    # the double kernels of the sheath engine's float64 state (item 19a):
    # the pass's and finalize's scalars (dt, dt/dx, c, wall_ratio) and the
    # hash normals' 2 pi as _D; the re-injection's cells, gamma and 2 pi
    # stay _F (its draws are the float kernel's, in float32)
    "pypic_sheath_picard_f64": (
        [_P] * 12 + [_L, _I] + [_D] * 4 + [_I, _I, _L, _P], _I),
    "pypic_sheath_finalize_f64": (
        [_P] * 13 + [_L, _I] + [_D] * 4 + [_I, _I, _L, _P], _I),
    "pypic_sheath_picard_large_f64": (
        [_P] * 12 + [_L, _I] + [_D] * 4 + [_I, _I, _L, _P], _I),
    "pypic_sheath_finalize_large_f64": (
        [_P] * 13 + [_L, _I] + [_D] * 4 + [_I, _I, _L, _P], _I),
    "pypic_deposit_det_f64": ([_P] * 5 + [_L, _I, _I, _I, _I, _L, _P], _I),
    "pypic_deposit_det_large_f64": ([_P] * 5 + [_L, _I, _I, _I, _I, _L, _P], _I),
    "pypic_sheath_reinject_f64": (
        [_P] * 12 + [_L, _U, _U, _U, _U, _F, _F, _F, _I, _I, _I, _P], _I),
    "pypic_hash_batch_f64": ([_P, _L, _I, _U, _U, _D, _I, _I, _I, _P], _I),
    "pypic_picard_iteration_ext": (
        [_P] * 10 + [_L, _I, _F, _F, _F, _F, _F, _I, _I, _I, _I, _F, _I, _I,
                     _I, _I, _P], _I),
    "pypic_picard_iteration_ext_clusters": ([_I] * 5 + [_P], _I),
    "pypic_picard_finalize_ext": (
        [_P] * 10 + [_L, _I, _F, _F, _F, _F, _F, _F, _I, _F, _I, _I, _I, _P],
        _I),
    "pypic_leapfrog_push": (
        [_P] * 5 + [_L, _I, _F, _F, _F, _I, _I, _I, _P], _I),
    "pypic_boris_gather_push_deposit": (
        [_P] * 16 + [_L, _I, _F, _F, _F, _F, _I, _I, _I, _F, _I, _I, _I, _I,
                     _I, _P], _I),
    # the double kernels of the magnetized engine's float64 state (item
    # 19b): rows 7-9, 22 and 23, every scalar _D
    "pypic_deposit2_f64": ([_P] * 5 + [_L, _I, _I, _I, _I, _I, _I, _P], _I),
    "pypic_boris_gather_push_f64": (
        [_P] * 11 + [_L, _I, _D, _D, _D, _D, _I, _I, _I, _I, _P], _I),
    "pypic_boris_gather_push_deposit_f64": (
        [_P] * 16 + [_L, _I, _D, _D, _D, _D, _I, _I, _I, _D, _I, _I, _I, _I,
                     _I, _P], _I),
    "pypic_boltzmann_dirichlet_f64": (
        [_P] * 6 + [_I, _I] + [_D] * 5 + [_I, _D, _D, _P], _I),
    "pypic_boltzmann_dn_f64": (
        [_P] * 6 + [_I, _I] + [_D] * 4 + [_I, _D, _D, _P], _I),
    "pypic_boltzmann_dirichlet_large_f64": (
        [_P] * 7 + [_I] * 3 + [_D] * 5 + [_I, _D, _D, _P], _I),
    "pypic_boltzmann_dn_large_f64": (
        [_P] * 7 + [_I] * 3 + [_D] * 4 + [_I, _D, _D, _P], _I),
    # the explicit engine's (item 19c): rows 14 and 13, every scalar _D
    "pypic_leapfrog_deposit_f64": (
        [_P, _P, _P, _P, _P, _P, _L, _I, _D, _D, _D, _D, _I, _I, _I, _I, _P], _I),
    "pypic_explicit_cycle_f64": (
        [_P, _P, _P, _P, _P, _P, _P, _L, _I, _D, _D, _D, _D, _D, _I, _I, _P],
        _I),
    "pypic_explicit_domain_cycle": (
        [_P] * 8 + [_L, _I, _I, _F, _F, _F, _F, _I, _I, _I, _P], _I),
    "pypic_error_string": ([_I], ctypes.c_char_p),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # compiler output (ptxas register / shared-memory report)


_loaded: tuple[ctypes.CDLL, BuildInfo] | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from pypic_tpu_torch/csrc at first use")
    return found


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpypic_cic_{h.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Compile csrc/*.cu into the keyed shared library unless it exists:
    one nvcc per source, all running at once, then one link. The compiler's
    report (ptxas -v) is kept beside the library and returned with it."""
    out = library_path()
    if out.exists():
        log = out.with_suffix(".log")
        return BuildInfo(out, 0.0, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    logs, failed = [], []
    for cmd, obj, proc in jobs:
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{logs[-1]}")
        out.with_suffix(f".{os.getpid()}.log").write_text("".join(logs))
        os.replace(out.with_suffix(f".{os.getpid()}.log"), out.with_suffix(".log"))
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return BuildInfo(out, time.perf_counter() - t0, "".join(logs))


def _kernel_of(mangled: str) -> tuple[str, tuple]:
    """A kernel's name and template arguments from its mangled name (the
    last of its length-prefixed names): bool and int arguments as ints,
    the element types float and double as 'f' and 'd', e.g.
    ``ILb0ELb1ELi2EdE`` -> (0, 1, 2, 'd')."""
    i, name = (3 if mangled.startswith("_ZN") else 2), ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        k = int(mangled[i:j])
        name, i = mangled[j:j + k], j + k
    args = re.match(r"I((?:L[a-z]\d+E|[fd])*)E", mangled[i:])
    if not args:
        return name, ()
    return name, tuple(int(v) if v else t for v, t in
                       re.findall(r"L[a-z](\d+)E|([fd])", args.group(1)))


def static_smem(log: str) -> dict[tuple[str, tuple[int, ...]], int]:
    """Each kernel's static shared-memory bytes from the compiler's report
    (ptxas -v in a BuildInfo's ``log``): {(name, template arguments): bytes}."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = _kernel_of(m.group(1))
            continue
        if "Used" in line and "registers" in line and entry is not None:
            m = re.search(r"(\d+) bytes smem", line)  # absent when 0
            out[entry] = max(out.get(entry, 0), int(m.group(1)) if m else 0)
            entry = None
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return load()[0]


def load() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load the library; returns (lib, BuildInfo)."""
    global _loaded
    if _loaded is None:
        info = build()
        lib = ctypes.CDLL(str(info.path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded = (lib, info)
    return _loaded


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().pypic_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
