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
when they lie on the CPU. Any other device, mixed devices, a dtype other
than float32, or a non-contiguous or mis-shaped tensor raises. A failed
build or launch raises; nothing falls back. The card's size limits
(shared memory a block, thread histograms) are checked in the CUDA branch
only, so the plain versions run any grid size on CPU tensors, as the JAX
package does.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel and nowhere else (the plain versions count nothing).

Particles are flat (n,) tensors of grid coordinates. The TPU kernels'
blocked layout, window geometry, fold/selection matrices and SMEM scalar
packing are not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..constants import EPSILON_0
from . import _build
from .accel import anderson_mix, mix_init
from .cic import cic_indices_weights
from .fd import smooth_periodic

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
            "boltzmann_dn_large": 0, "tridiag3_chain_large": 0}

_THREADS = 256
_BLOCKS_PER_SM = 8  # 8 x 256 threads fill an SM's 2048 thread slots
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448
# lane columns a histogram of the wide deposits at most (deposit_launch_shape)
DEPOSIT_MAX_COLS = 32
# the field alone in one block's shared memory (csrc kFieldSmemMaxNg): the
# large modes read it from device memory above this ng
FIELD_SMEM_MAX_NG = SMEM_LIMIT // 4
# the large modes' limit on ng (the deterministic sums of deposit_det and
# the sheath pass, deposit2 and the carried Boris deposit): float32
# positions below 2^22 still resolve a quarter cell, and the int64 sums
# of deposit_det take 8 ng bytes (32 MiB here)
LARGE_MAX_NG = 1 << 22


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _device_kind(tensors) -> str:
    """'cuda' or 'cpu' for a set of float32 tensors on one device; raises on
    anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 tensors, got {t.dtype}")
    return dev.type


def _check_1d(name: str, t: torch.Tensor, size: int) -> None:
    if t.dim() != 1 or t.shape[0] != size:
        raise ValueError(f"{name} must have shape ({size},), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ng(ng: int) -> None:
    if ng < 2:
        raise ValueError(f"ng must be >= 2, got {ng}")


def _check_smem(ng: int, arrays: int, what: str, extra: int = 0) -> None:
    """A block keeps ``arrays`` float32 arrays of ng nodes (and ``extra``
    bytes) in shared memory. A limit of the card's kernels only: the
    wrappers call it in their CUDA branch, so the plain versions on CPU
    tensors run any ng."""
    need = arrays * ng * 4 + extra
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{what}: ng={ng} needs {need} B of shared memory, "
            f"above the {SMEM_LIMIT} B a block may use (ng <= "
            f"{(SMEM_LIMIT - extra) // (4 * arrays)}); the large-ng variant "
            "is ROADMAP item 10")


def check_large_ng(ng: int, what: str) -> None:
    """The large modes' limit (a limit of the card's kernels only)."""
    if ng > LARGE_MAX_NG:
        raise ValueError(f"{what}: ng={ng} is above LARGE_MAX_NG = {LARGE_MAX_NG}, "
                         "the large mode's limit (float32 positions resolve a "
                         "quarter cell below it)")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(n: int, device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return max(1, min(-(-n // _THREADS), _BLOCKS_PER_SM * _sm_count(index)))


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def kernel_scalars(qm: float, dt: float, dx: float, w: float):
    """Kernel scalars as ``pallas_cic._scalars`` computes them: float32
    arithmetic from the float32 q/m, in the same order.
    Returns (qm dt, qm dt (dt/dx) / 2, dt/dx, w), each a Python float
    holding a float32 value."""
    f32 = np.float32
    qm = f32(qm)
    qm_dt = qm * f32(dt)
    qm_dt2_half = f32(0.5) * qm * f32(dt) * f32(dt / dx)
    return float(qm_dt), float(qm_dt2_half), float(f32(dt / dx)), float(f32(w))


def leapfrog_scalars(qm: float, dt: float, dx: float, w: float):
    """Scalars of the leapfrog kernels as the Pallas wrappers compute them
    (pallas_cic.py:868-871, 1097-1100): ``0.5 * qm * dt`` in float32 from
    the float32 q/m, ``dt / dx`` and ``w`` rounded to float32.
    Returns (qm dt / 2, dt/dx, w), each a Python float holding a float32
    value."""
    f32 = np.float32
    qmh = f32(0.5) * f32(qm) * f32(dt)
    return float(qmh), float(f32(dt / dx)), float(f32(w))


def _inv(ng: int) -> float:
    return float(np.float32(1.0 / ng))


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
    return x - torch.floor(x * _inv(ng)) * ng


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


def picard_iteration_plain(field_smoothed, ps, p0, v0, ng: int, *, qm, w,
                           dt: float, dx: float, emit_v: bool = False):
    qm_dt, qm_dt2_half, dt_dx, w = kernel_scalars(qm, dt, dx, w)
    p1, v1 = _cn_push(field_smoothed, ps, p0, v0, qm_dt, qm_dt2_half, dt_dx)
    ph = _wrap(0.5 * (p0 + p1), ng)
    vh = 0.5 * (v0 + v1)
    jh = deposit_plain(ph, w * vh, ng, periodic=True)
    return (ph, v1, jh) if emit_v else (ph, jh)


def picard_finalize_nodep_plain(field_smoothed, ps, p0, v0, ng: int, *, qm,
                                dt: float, dx: float):
    qm_dt, qm_dt2_half, dt_dx, _ = kernel_scalars(qm, dt, dx, 0.0)
    p1, v1 = _cn_push(field_smoothed, ps, p0, v0, qm_dt, qm_dt2_half, dt_dx)
    return _wrap(p1, ng), v1


def picard_finalize_plain(field_smoothed, ps, p0, v0, ng: int, *, qm, w,
                          dt: float, dx: float):
    p1, v1 = picard_finalize_nodep_plain(field_smoothed, ps, p0, v0, ng,
                                         qm=qm, dt=dt, dx=dx)
    wf = kernel_scalars(qm, dt, dx, w)[3]
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


def _shared_frame_args(ng: int):
    """(stride, width, K, float32 1/stride) of the shared-window frame."""
    stride, width = window_sw(ng)
    return stride, width, (ng - 1) // stride + 1, float(np.float32(1.0 / stride))


def picard_iteration_shared_plain(field_smoothed, ps, p0, v0, ng: int, *, qm,
                                  w, dt: float, dx: float,
                                  emit_v: bool = False, acc_dtype=None):
    """``acc_dtype`` is the dtype jh is summed in (float32 by default):
    float64 sums the same float32 terms into a reference for the kernel's
    float32 sums."""
    qm_dt, qm_dt2_half, dt_dx, w = kernel_scalars(qm, dt, dx, w)
    p1, v1 = _cn_push(field_smoothed, ps, p0, v0, qm_dt, qm_dt2_half, dt_dx)
    raw = 0.5 * (p0 + p1)
    vh = 0.5 * (v0 + v1)
    # the midpoint's row in the gather's window frame (pallas_cic.py
    # _window_decompose, _shared_gather and _picard_iter_sw_kernel)
    stride, width, num_k, inv_stride = _shared_frame_args(ng)
    k = torch.clamp((torch.floor(ps) * inv_stride).to(torch.int32), 0, num_k - 1)
    d_s = (ps - k.to(ps.dtype) * stride) + 1.0
    delta = raw - ps
    delta = delta - torch.round(delta * _inv(ng)) * ng  # nearest image
    d_h = d_s + delta
    oob = (d_h < 0.0) | (d_h > width - 1.0)
    d_h = torch.clamp(d_h, 0.0, width - 1.0)
    row = torch.clamp(torch.floor(d_h).to(torch.int64), max=width - 2)
    wr = d_h - row.to(d_h.dtype)
    node = torch.remainder(stride * k.to(torch.int64) + row - 1, ng)
    right = torch.where(node + 1 == ng, 0, node + 1)
    vals = w * vh
    acc = acc_dtype or vals.dtype
    jh = torch.zeros((ng,), dtype=acc, device=vals.device)
    jh.index_add_(0, node, (vals * (1.0 - wr)).to(acc))
    jh.index_add_(0, right, (vals * wr).to(acc))
    n_clamped = oob.sum().to(torch.int32)
    ph = _wrap(raw, ng)
    return (ph, v1, jh, n_clamped) if emit_v else (ph, jh, n_clamped)


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
    qmh, dt_dx, wf = leapfrog_scalars(qm, dt, dx, w)
    p1, v1 = _leapfrog(field, p, v, qmh, dt_dx, ng)
    return p1, v1, deposit_plain(p1, torch.full_like(p1, wf), ng, periodic=True)


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


def _check_pass(field, ps, p0, v0, ng):
    kind = _device_kind((field, ps, p0, v0))
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
    velocity). ``qm`` and ``w`` are the float32 scalars q/m and
    q p2c / dx."""
    kind, n = _check_pass(field_smoothed, ps, p0, v0, ng)
    _check_ng(ng)
    if kind == "cpu":
        return picard_iteration_plain(field_smoothed, ps, p0, v0, ng, qm=qm,
                                      w=w, dt=dt, dx=dx, emit_v=emit_v)
    _check_smem(ng, 2, "picard_iteration")
    lib = _build.library()
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w)
    dev = ps.device
    ph = torch.empty_like(ps)
    v1 = torch.empty_like(ps) if emit_v else None
    jh = torch.zeros((ng,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_picard_iteration(
            field_smoothed.data_ptr(), ps.data_ptr(), p0.data_ptr(),
            v0.data_ptr(), ph.data_ptr(), v1.data_ptr() if emit_v else None,
            jh.data_ptr(), n, ng, qm_dt, qm_dt2_half, dt_dx, wf, _inv(ng),
            _blocks(n, dev), _THREADS, _stream(dev))
    _build.check(err, "picard_iteration")
    LAUNCHES["picard_iteration"] += 1
    return (ph, v1, jh) if emit_v else (ph, jh)


def picard_finalize_nodep(field_smoothed, ps, p0, v0, ng: int, *, qm,
                          dt: float, dx: float):
    """Post-convergence sweep without the j1 deposit: final (p1, v1), p1
    wrapped."""
    kind, n = _check_pass(field_smoothed, ps, p0, v0, ng)
    _check_ng(ng)
    if kind == "cpu":
        return picard_finalize_nodep_plain(field_smoothed, ps, p0, v0, ng,
                                           qm=qm, dt=dt, dx=dx)
    _check_smem(ng, 1, "picard_finalize_nodep")
    lib = _build.library()
    qm_dt, qm_dt2_half, dt_dx, _ = kernel_scalars(qm, dt, dx, 0.0)
    dev = ps.device
    p1 = torch.empty_like(ps)
    v1 = torch.empty_like(ps)
    with torch.cuda.device(dev):
        err = lib.pypic_picard_finalize_nodep(
            field_smoothed.data_ptr(), ps.data_ptr(), p0.data_ptr(),
            v0.data_ptr(), p1.data_ptr(), v1.data_ptr(), n, ng, qm_dt,
            qm_dt2_half, dt_dx, _inv(ng), _blocks(n, dev), _THREADS,
            _stream(dev))
    _build.check(err, "picard_finalize_nodep")
    LAUNCHES["picard_finalize_nodep"] += 1
    return p1, v1


# (device, stream, blocks, ng) -> (partials, block counter): the scratch
# of the deterministic sums, kept across calls. The counter is zeroed once
# here; the last block of each launch sets it back to 0 (det_flush and
# csrc/sheath.cu sheath_flush), and launches on one stream run in order,
# so a call allocates and fills nothing.
_DET_SCRATCH: dict = {}


def det_buffers(dev, blocks: int, ng: int):
    """(per-block partials, zeroed block counter) of a deterministic sum
    over ``blocks`` blocks of ng nodes, cached by device, stream and shape.
    Call it with ``dev`` current."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, _stream(dev), blocks, ng)
    if key not in _DET_SCRATCH:
        _DET_SCRATCH[key] = (
            torch.empty((blocks * ng,), dtype=torch.float32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    return _DET_SCRATCH[key]


def large_scratch(dev, blocks: int, ng: int):
    """(per-block maxima, int64 node sums) of a large deterministic sum
    (cic_common.cuh "Large deterministic sums"): 4 blocks + 8 ng bytes,
    written by the kernels before they read them, so nothing is zeroed or
    kept across calls."""
    return (torch.empty((blocks,), dtype=torch.float32, device=dev),
            torch.empty((ng,), dtype=torch.int64, device=dev))


def deterministic_scratch(n: int, ng: int, dev):
    """(launch shape, scratch a, scratch b) of the deterministic deposit:
    the sheath pass's grid without the field
    (``cuda_sheath.launch_shape(n, ng, sms, field=False)``: persistent
    blocks over contiguous row ranges), fixed by n, ng and the card. Up to
    ng = 1,816 a column of ng floats a thread and the summed order of
    ``det_buffers`` (per-block partials, zeroed block counter); above it
    the large mode's int64 fixed-point sums in ``large_scratch`` (per-block
    maxima, node sums). Call it with ``dev`` current. Raises above
    LARGE_MAX_NG."""
    from .cuda_sheath import launch_shape

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    shape = launch_shape(max(n, 1), ng, _sm_count(index), field=False)
    if shape.large:
        return (shape, *large_scratch(dev, shape.blocks, ng))
    return (shape, *det_buffers(dev, shape.blocks, ng))


ROW_ALIGN = 4  # floats: 16 B


def padded_rows(k: int, n: int, device) -> tuple[torch.Tensor, ...]:
    """``k`` (n,) float32 outputs cut from one (k, pitch) buffer whose row
    pitch rounds n up to a multiple of 4 floats: each view is contiguous
    and starts 16-B aligned, so the kernels that read them next take
    16-B loads whatever n is."""
    pitch = -(-n // ROW_ALIGN) * ROW_ALIGN
    buf = torch.empty((k, pitch), dtype=torch.float32, device=device)
    return tuple(buf[r, :n] for r in range(k))


def deposit(p, values, ng: int, *, periodic: bool, cols: int = DEPOSIT_MAX_COLS):
    """CIC-deposit per-particle ``values`` at grid positions ``p`` onto ng
    nodes (values carry every prefactor; masked particles carry 0). On the
    card the grid is ``deposit_launch_shape(n, ng, False, sms, hists=1,
    max_cols=cols)`` and a product of exactly 0 adds nothing (csrc/cic.cu).
    ``cols`` caps the wide grid's lane columns (a power of two up to 32):
    dense values want the most, whose adds then never share a word within a
    warp; a histogram whose weights are mostly 0 (``ops.cic.histogram_add``)
    wants 1, which spares zeroing and summing the others (PERF.md §6). It
    changes the order of the float sums only."""
    kind = _device_kind((p, values))
    n = p.shape[0] if p.dim() == 1 else -1
    _check_1d("p", p, n)
    _check_1d("values", values, n)
    _check_ng(ng)
    if kind == "cpu":
        return deposit_plain(p, values, ng, periodic=periodic)
    lib = _build.library()
    dev = p.device
    with torch.cuda.device(dev):
        shape = _deposit_shape(dev, n, ng, False, hists=1, max_cols=cols)
        out = torch.zeros((ng,), dtype=torch.float32, device=dev)
        err = lib.pypic_deposit(p.data_ptr(), values.data_ptr(),
                                out.data_ptr(), n, ng, int(periodic),
                                shape.rows, shape.blocks, shape.threads,
                                shape.cols, _stream(dev))
    _build.check(err, "deposit")
    LAUNCHES["deposit"] += 1
    return out


def deposit_det(p, values, ng: int, *, periodic: bool):
    """``deposit`` with the sums in a fixed order on the card (no float
    atomics), so that a call gives the same bits every time: up to ng =
    1,816 a column a thread and cic_common.cuh det_flush's ordered sums,
    above it (up to LARGE_MAX_NG) int64 fixed-point sums, exact and
    associative (csrc/cic.cu deposit_det_large_kernel). CPU tensors take
    the plain deposit at any ng. The sheath engine's composed loop and exit
    histograms use it: its floor exit reads the residual at round-off
    level. The other engines keep the float-atomic ``deposit``."""
    kind = _device_kind((p, values))
    n = p.shape[0] if p.dim() == 1 else -1
    _check_1d("p", p, n)
    _check_1d("values", values, n)
    _check_ng(ng)
    if kind == "cpu":
        return deposit_plain(p, values, ng, periodic=periodic)
    lib = _build.library()
    dev = p.device
    out = torch.empty((ng,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        shape, a, b = deterministic_scratch(n, ng, dev)
        fn = lib.pypic_deposit_det_large if shape.large else lib.pypic_deposit_det
        err = fn(p.data_ptr(), values.data_ptr(), out.data_ptr(), a.data_ptr(),
                 b.data_ptr(), n, ng, int(periodic), shape.blocks, shape.threads,
                 shape.rows_per_block, _stream(dev))
    _build.check(err, "deposit_det")
    LAUNCHES["deposit_det"] += 1
    return out


def gather(field, p, *, periodic: bool):
    """CIC gather of the (ng,) node field at grid positions p: (n,)."""
    kind = _device_kind((field, p))
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    _check_1d("p", p, p.shape[0] if p.dim() == 1 else -1)
    _check_ng(ng)
    if kind == "cpu":
        return gather_plain(field, p, periodic=periodic)
    _check_smem(ng, 1, "gather")
    lib = _build.library()
    n = p.shape[0]
    dev = p.device
    out = torch.empty_like(p)
    with torch.cuda.device(dev):
        err = lib.pypic_gather(field.data_ptr(), p.data_ptr(), out.data_ptr(),
                               n, ng, int(periodic), _blocks(n, dev),
                               _THREADS, _stream(dev))
    _build.check(err, "gather")
    LAUNCHES["gather"] += 1
    return out


def _check_leapfrog(field, p, v):
    kind = _device_kind((field, p, v))
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    n = p.shape[0] if p.dim() == 1 else -1
    _check_1d("p", p, n)
    _check_1d("v", v, n)
    return kind, n, ng


def leapfrog_gather_push_deposit(field, p, v, *, qm, w, dt: float, dx: float):
    """One sweep of the explicit cycle: gather the field at p, leapfrog,
    wrap, and deposit the charge density of the NEW positions. Returns
    (p1, v1, rho1). ``qm`` and ``w`` are the float32 scalars q/m and
    q p2c / dx."""
    kind, n, ng = _check_leapfrog(field, p, v)
    _check_ng(ng)
    if kind == "cpu":
        return leapfrog_gather_push_deposit_plain(field, p, v, qm=qm, w=w,
                                                  dt=dt, dx=dx)
    _check_smem(ng, 2, "leapfrog_gather_push_deposit")
    lib = _build.library()
    qmh, dt_dx, wf = leapfrog_scalars(qm, dt, dx, w)
    dev = p.device
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    rho = torch.zeros((ng,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_leapfrog_deposit(
            field.data_ptr(), p.data_ptr(), v.data_ptr(), p1.data_ptr(),
            v1.data_ptr(), rho.data_ptr(), n, ng, qmh, dt_dx, wf, _inv(ng),
            _blocks(n, dev), _THREADS, _stream(dev))
    _build.check(err, "leapfrog_gather_push_deposit")
    LAUNCHES["leapfrog_gather_push_deposit"] += 1
    return p1, v1, rho


# shared memory of explicit_cycle beside its two float arrays: ng + 32
# float64 (the solve's scan and reduction scratch) = 2 ng floats + 256 B
_CYCLE_ARRAYS, _CYCLE_EXTRA = 4, 256


def explicit_cycle(e_field, p, v, ng: int, *, qm, w, dt: float, dx: float):
    """The whole explicit cycle in one launch: the leapfrog sweep and the
    solve of the deposited rho for the next step's field. Returns
    (p1, v1, rho1, e1)."""
    kind, n, _ = _check_leapfrog(e_field, p, v)
    _check_1d("e_field", e_field, ng)
    _check_ng(ng)
    if kind == "cpu":
        return explicit_cycle_plain(e_field, p, v, ng, qm=qm, w=w, dt=dt,
                                    dx=dx)
    _check_smem(ng, _CYCLE_ARRAYS, "explicit_cycle", _CYCLE_EXTRA)
    lib = _build.library()
    qmh, dt_dx, wf = leapfrog_scalars(qm, dt, dx, w)
    dev = p.device
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    # rho and, after it, the epilogue's block counter: one zeroed buffer
    buf = torch.zeros((ng + 1,), dtype=torch.float32, device=dev)
    e1 = torch.empty((ng,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_explicit_cycle(
            e_field.data_ptr(), p.data_ptr(), v.data_ptr(), p1.data_ptr(),
            v1.data_ptr(), buf.data_ptr(), e1.data_ptr(), n, ng, qmh, dt_dx,
            wf, _inv(ng), _solve_coef(dx), _blocks(n, dev), _THREADS,
            _stream(dev))
    _build.check(err, "explicit_cycle")
    LAUNCHES["explicit_cycle"] += 1
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
    kind, n, _ = _check_leapfrog(e_field, p, v)
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
    kind, n = _check_pass(field_smoothed, ps, p0, v0, ng)
    _check_ng(ng)
    if kind == "cpu":
        return picard_finalize_plain(field_smoothed, ps, p0, v0, ng, qm=qm,
                                     w=w, dt=dt, dx=dx)
    _check_smem(ng, 2, "picard_finalize")
    lib = _build.library()
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w)
    dev = ps.device
    p1 = torch.empty_like(ps)
    v1 = torch.empty_like(ps)
    j1 = torch.zeros((ng,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_picard_finalize(
            field_smoothed.data_ptr(), ps.data_ptr(), p0.data_ptr(),
            v0.data_ptr(), p1.data_ptr(), v1.data_ptr(), j1.data_ptr(), n, ng,
            qm_dt, qm_dt2_half, dt_dx, wf, _inv(ng), _blocks(n, dev),
            _THREADS, _stream(dev))
    _build.check(err, "picard_finalize")
    LAUNCHES["picard_finalize"] += 1
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
    kind, n = _check_pass(field_smoothed, ps, p0, v0, ng)
    _check_ng(ng)
    if kind == "cpu":
        return picard_iteration_shared_plain(field_smoothed, ps, p0, v0, ng,
                                             qm=qm, w=w, dt=dt, dx=dx,
                                             emit_v=emit_v)
    _check_smem(ng, 2, "picard_iteration_shared")
    lib = _build.library()
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w)
    stride, width, num_k, inv_stride = _shared_frame_args(ng)
    dev = ps.device
    ph = torch.empty_like(ps)
    v1 = torch.empty_like(ps) if emit_v else None
    jh = torch.zeros((ng,), dtype=torch.float32, device=dev)
    n_clamped = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_picard_iteration_shared(
            field_smoothed.data_ptr(), ps.data_ptr(), p0.data_ptr(),
            v0.data_ptr(), ph.data_ptr(), v1.data_ptr() if emit_v else None,
            jh.data_ptr(), n_clamped.data_ptr(), n, ng, qm_dt, qm_dt2_half,
            dt_dx, wf, _inv(ng), stride, width, num_k, inv_stride,
            _blocks(n, dev), _THREADS, _stream(dev))
    _build.check(err, "picard_iteration_shared")
    LAUNCHES["picard_iteration_shared"] += 1
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
    kind = _device_kind((e0, e_prev, j0, p, v))
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


@dataclasses.dataclass(frozen=True)
class DepositShape:
    """The launch of ``deposit`` (one histogram), ``deposit2`` (two) or
    ``boris_gather_push_deposit`` (two and the field): ``blocks`` blocks of
    ``threads`` threads, ``rows`` rows a thread and pass (4 with 16-B
    accesses, or 1); block b sweeps the units of ``rows`` rows [b U / B,
    (b + 1) U / B), U = ceil(n / rows), B = blocks; each histogram has
    ``cols`` lane columns a node (0: the large mode, no shared histogram);
    ``smem`` bytes of dynamic shared memory a block (the columns, and the
    field for row 9)."""
    rows: int
    blocks: int
    threads: int
    cols: int
    smem: int


def deposit_launch_shape(n: int, ng: int, field: bool, sms: int,
                         hists: int = 2, max_cols: int = DEPOSIT_MAX_COLS) -> DepositShape:
    """The grid of the wide deposits for n rows and ng nodes on a card of
    ``sms`` SMs, a function of these alone: ``hists`` histograms (1 for
    ``deposit``, 2 for ``deposit2`` and, with ``field``, the carried Boris
    deposit). Wide where every thread of one 1,024-thread block an SM gets
    a group of four rows: one such block an SM, ``max_cols`` (32) lane
    columns, halved until shared memory holds them. Narrow below that: the
    first port's grid, a row a thread, no more blocks than the rows fill.
    Where one column does not fit (above ng = 29,056 for deposit2, 19,370
    with the field) two histograms take the large mode: the same rows a
    block, ``cols`` 0 (no shared histogram, every add a global atomic),
    ``smem`` the field's where it fits alone (ng <= FIELD_SMEM_MAX_NG),
    else 0; it raises above LARGE_MAX_NG. ``deposit`` (one histogram)
    raises above 58,112 (ROADMAP item 10)."""
    if (n < 0 or ng < 2 or sms < 1 or (hists, field) not in _DEPOSIT_NAMES
            or max_cols not in (1, 2, 4, 8, 16, 32)):
        raise ValueError(f"deposit_launch_shape needs n >= 0, ng >= 2, sms >= 1, "
                         f"1 or 2 histograms (2 with the field) and max_cols a power "
                         f"of two up to 32; got {n}, {ng}, {sms}, {hists}, {max_cols}")
    name = _DEPOSIT_NAMES[(hists, field)]
    large = hists == 2 and 4 * (hists + int(field)) * ng > SMEM_LIMIT
    if large:
        check_large_ng(ng, name)
    else:
        _check_smem(ng, hists + int(field), name)

    def smem(cols: int) -> int:
        if large:
            return 4 * ng if field and ng <= FIELD_SMEM_MAX_NG else 0
        return 4 * (hists * cols + int(field)) * ng

    if n >= 4 * DEPOSIT_WIDE_THREADS * sms:
        cols = 0 if large else max_cols
        while smem(cols) > SMEM_LIMIT:
            cols //= 2
        return DepositShape(4, sms, DEPOSIT_WIDE_THREADS, cols, smem(cols))
    blocks = max(1, min(-(-n // DEPOSIT_NARROW_THREADS), _BLOCKS_PER_SM * sms))
    cols = 0 if large else 1
    return DepositShape(1, blocks, DEPOSIT_NARROW_THREADS, cols, smem(cols))


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
                   max_cols: int = DEPOSIT_MAX_COLS) -> DepositShape:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return deposit_launch_shape(n, ng, field, _sm_count(index), hists, max_cols)


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
    (a, b). Positions off the grid (wall-lost slots, weight 0) are clamped
    into it as ``ops.cic.cic_indices_weights`` clamps them."""
    kind = _device_kind((p, va, vb))
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in (("p", p), ("va", va), ("vb", vb)):
        _check_1d(name, t, n)
    _check_ng(ng)
    if kind == "cpu":
        return deposit2_plain(p, va, vb, ng, periodic=periodic)
    lib = _build.library()
    dev = p.device
    out = torch.zeros((2, ng), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        shape = _deposit_shape(dev, n, ng, False)
        err = lib.pypic_deposit2(p.data_ptr(), va.data_ptr(), vb.data_ptr(),
                                 out[0].data_ptr(), out[1].data_ptr(), n, ng,
                                 int(periodic), shape.rows, shape.blocks,
                                 shape.threads, shape.cols, _stream(dev))
    _build.check(err, "deposit2")
    LAUNCHES["deposit2"] += 1
    return out[0], out[1]


def boris_scalars(b, dt_dx: float):
    """(bx, by, bz, dt/dx), each a Python float holding the float32 value
    the TPU kernel bakes in (Python floats, weakly typed, round to float32
    at their first operation)."""
    f32 = np.float32
    return tuple(float(f32(x)) for x in (*b, dt_dx))


def boris_gather_push_plain(field, p, vx, vy, vz, const, act, *, b,
                            dt_dx: float, swap_weights: bool = False):
    """The fused kernel's arithmetic as tensor operations
    (pallas_cic.py _boris_kernel): the bounded gather at
    clip(p, 0, ng - 1), or at its cell mirror with ``swap_weights``; the
    Boris rotation with inv = 2 / (1 + t^2), s = t inv; p1 = p + vx dt/dx.
    Rows with act == 0 keep their inputs."""
    ng = field.shape[0]
    bx, by, bz, dt_dx = boris_scalars(b, dt_dx)
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

    Returns (p1, vx1, vy1, vz1).
    """
    arrays = (p, vx, vy, vz, const, act)
    kind = _device_kind((field,) + arrays)
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in zip(("p", "vx", "vy", "vz", "const", "act"), arrays):
        _check_1d(name, t, n)
    _check_ng(ng)
    if kind == "cpu":
        return boris_gather_push_plain(field, p, vx, vy, vz, const, act, b=b,
                                       dt_dx=dt_dx, swap_weights=swap_weights)
    _check_smem(ng, 1, "boris_gather_push")
    lib = _build.library()
    bx, by, bz, dt_dx32 = boris_scalars(b, dt_dx)
    dev = p.device
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_boris_gather_push(
            field.data_ptr(), p.data_ptr(), vx.data_ptr(), vy.data_ptr(),
            vz.data_ptr(), const.data_ptr(), act.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(), n, ng,
            bx, by, bz, dt_dx32, int(bool(swap_weights)), _blocks(n, dev),
            _THREADS, _stream(dev))
    _build.check(err, "boris_gather_push")
    LAUNCHES["boris_gather_push"] += 1
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


def _carry_frame(ng: int):
    """(stride, K, float32 1/stride) of ``window(ng)``."""
    stride, _ = window(ng)
    return stride, (ng - 1) // stride + 1, float(np.float32(1.0 / stride))


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
    stride, num_k, inv_stride = _carry_frame(ng)
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
    int32 0-d tensor on the particles' device.
    """
    arrays = (p, vx, vy, vz, const, act, wr, wn)
    kind = _device_kind((field,) + arrays)
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
    lib = _build.library()
    bx, by, bz, dt_dx32 = boris_scalars(b, dt_dx)
    stride, num_k, inv_stride = _carry_frame(ng)
    dev = p.device
    out = padded_rows(4, n, dev)
    dens = torch.zeros((2, ng), dtype=torch.float32, device=dev)
    n_clamped = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        shape = _deposit_shape(dev, n, ng, True)
        err = lib.pypic_boris_gather_push_deposit(
            field.data_ptr(), *(t.data_ptr() for t in arrays),
            *(o.data_ptr() for o in out), dens[0].data_ptr(),
            dens[1].data_ptr(), n_clamped.data_ptr(), n, ng, bx, by, bz,
            dt_dx32, int(bool(swap_weights)), stride, num_k, inv_stride,
            int(pad), shape.rows, shape.blocks, shape.threads, shape.cols,
            _stream(dev))
    _build.check(err, "boris_gather_push_deposit")
    LAUNCHES["boris_gather_push_deposit"] += 1
    return out[0], out[1], out[2], out[3], dens[0], dens[1], n_clamped
