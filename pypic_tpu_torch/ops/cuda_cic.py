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
  explicit cycles per launch with per-step metric rows, n <= 32768);
* ``picard_finalize``       — ``picard_finalize_pallas`` (the converged
  finalize sweep plus the full-step current deposit,
  finalize='converged-deposit');
* ``picard_iteration_shared`` — ``picard_iteration_pallas(share_window=True)``
  (the Picard pass depositing in the gather's window frame, clamps
  counted);
* ``implicit_resident``     — ``implicit_resident_pallas`` (S implicit
  CN-Picard steps per launch with per-step metric rows, n <= 131072);
* ``deposit2``              — ``deposit2_pallas`` (two bounded deposits,
  rho and n, in one sweep);
* ``boris_gather_push``     — ``boris_gather_push_pallas`` (bounded,
  optionally mirrored, gather + Boris-Buneman push).

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
            "leapfrog_gather_push": 0}

_THREADS = 256
_BLOCKS_PER_SM = 8  # 8 x 256 threads fill an SM's 2048 thread slots
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448


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
            "is not ported yet")


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
    best = None
    for width in (8, 16, 24, 32, 48, 64, 96, 128):
        stride = width - 4
        cost = 3 * width + 2 * ((ng - 1) // stride + 1)
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


def det_threads(ng: int, extra: int, what: str) -> int:
    """Threads a block of a deterministic deposit (cic_common.cuh
    det_flush): the largest power of two <= 256 whose thread histograms
    (threads x ng floats) and ``extra`` (ng,) arrays fit in a block's
    shared memory."""
    threads = _THREADS
    while threads >= 32 and (threads + extra) * ng * 4 > SMEM_LIMIT:
        threads //= 2
    if threads < 32:
        raise ValueError(
            f"{what}: ng={ng} leaves no room for 32 thread histograms in "
            f"{SMEM_LIMIT} B of shared memory (ng <= "
            f"{SMEM_LIMIT // (4 * (32 + extra))}); the large-ng variant is "
            "not ported yet")
    return threads


# (device, stream, blocks, ng) -> (partials, block counter): the scratch
# of the deterministic sums, kept across calls. The counter is zeroed once
# here; the last block of each launch sets it back to 0 (det_flush), and
# launches on one stream run in order, so a call allocates and fills
# nothing.
_DET_SCRATCH: dict = {}


def deterministic_scratch(n: int, ng: int, dev, extra: int = 0,
                          what: str = "deposit"):
    """(blocks, threads, per-block partials, zeroed block counter) of a
    deterministic deposit: the grid is fixed by n, ng and the card, so the
    sums' order is too. One wave: as many blocks as the card holds at
    once, fewer for a small n. Call it with ``dev`` current."""
    threads = det_threads(ng, extra, what)
    smem = (threads + extra) * ng * 4
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    per_sm = max(1, min(2048 // threads, SMEM_LIMIT // smem))
    blocks = max(1, min(-(-n // threads), per_sm * _sm_count(index)))
    key = (index, _stream(dev), blocks, ng)
    if key not in _DET_SCRATCH:
        _DET_SCRATCH[key] = (
            torch.empty((blocks * ng,), dtype=torch.float32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    partial, counter = _DET_SCRATCH[key]
    return blocks, threads, partial, counter


def deposit(p, values, ng: int, *, periodic: bool):
    """CIC-deposit per-particle ``values`` at grid positions ``p`` onto ng
    nodes (values carry every prefactor; masked particles carry 0)."""
    kind = _device_kind((p, values))
    n = p.shape[0] if p.dim() == 1 else -1
    _check_1d("p", p, n)
    _check_1d("values", values, n)
    _check_ng(ng)
    if kind == "cpu":
        return deposit_plain(p, values, ng, periodic=periodic)
    _check_smem(ng, 1, "deposit")
    lib = _build.library()
    dev = p.device
    out = torch.zeros((ng,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_deposit(p.data_ptr(), values.data_ptr(),
                                out.data_ptr(), n, ng, int(periodic),
                                _blocks(n, dev), _THREADS, _stream(dev))
    _build.check(err, "deposit")
    LAUNCHES["deposit"] += 1
    return out


def deposit_det(p, values, ng: int, *, periodic: bool):
    """``deposit`` with the sums in a fixed order on the card (no float
    atomics: cic_common.cuh det_flush), so that a call gives the same bits
    every time; on the card ng <= 227 at 256 thread histograms a block, up
    to 1,816 at 32 (CPU tensors take the plain deposit at any ng).
    The sheath engine's composed loop and exit histograms use it: its
    floor exit reads the residual at round-off level. Slower than
    ``deposit`` at the other engines' shapes (PERF.md §6), which keep the
    float-atomic kernel."""
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
        blocks, threads, partial, counter = deterministic_scratch(
            n, ng, dev, 0, "deposit_det")
        err = lib.pypic_deposit_det(
            p.data_ptr(), values.data_ptr(), out.data_ptr(),
            partial.data_ptr(), counter.data_ptr(), n, ng, int(periodic),
            blocks, threads, _stream(dev))
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


RESIDENT_MAX_N = 32768  # one cluster of 8 blocks x 1024 threads x 4 particles
# shared memory of the resident kernel: e, rho and two histograms (4 ng
# floats), ng + 36 float64 of solve and reduction scratch
_RESIDENT_ARRAYS, _RESIDENT_EXTRA = 6, 36 * 8


def explicit_cycle_resident(e_field, p, v, ng: int, steps: int, *, qm, w,
                            ke_c: float, jb_c: float, dt: float, dx: float,
                            fe_c: float):
    """``steps`` explicit cycles in one launch with the population held on
    chip (n <= 32768). Returns (p1, v1, rho1, e1, fe, ke, jb), the last
    three (steps,) rows of the pre-push field energy fe_c sum(e^2), kinetic
    energy ke_c sum(v^2) and current bias jb_c sum(v)."""
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
    _check_smem(ng, _RESIDENT_ARRAYS, "explicit_cycle_resident",
                _RESIDENT_EXTRA)
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
            rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(), n, ng,
            int(steps), qmh, dt_dx, wf, _inv(ng), _solve_coef(dx),
            float(fe_c), float(ke_c), float(jb_c), _stream(dev))
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
# shared memory of the implicit resident kernel: ten (ng,) float arrays
# and 36 float64 of reduction scratch and metric partials
_IMPLICIT_ARRAYS, _IMPLICIT_EXTRA = 10, 36 * 8


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
    iters (int32), resid, tracer_x and tracer_v."""
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
    _check_smem(ng, _IMPLICIT_ARRAYS, "implicit_resident", _IMPLICIT_EXTRA)
    lib = _build.library()
    qm_dt, qm_dt2_half, dt_dx, wf = kernel_scalars(qm, dt, dx, w)
    dev = p.device
    s = int(steps)
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    ps = torch.empty_like(p)
    fields = torch.empty((3, ng), dtype=torch.float32, device=dev)
    rows = torch.zeros((6, s), dtype=torch.float32, device=dev)
    iters = torch.zeros((s,), dtype=torch.int32, device=dev)
    jb_c = float(np.float32(wf) / np.float32(ng))
    with torch.cuda.device(dev):
        err = lib.pypic_implicit_resident(
            e0.data_ptr(), e_prev.data_ptr(), j0.data_ptr(), p.data_ptr(),
            v.data_ptr(), p1.data_ptr(), v1.data_ptr(), ps.data_ptr(),
            fields[0].data_ptr(), fields[1].data_ptr(), fields[2].data_ptr(),
            rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
            iters.data_ptr(), rows[3].data_ptr(), rows[4].data_ptr(),
            rows[5].data_ptr(), n, ng, s, qm_dt, qm_dt2_half, dt_dx, wf,
            _inv(ng), float(np.float32(dt / EPSILON_0)),
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
    _check_smem(ng, 2, "deposit2")
    lib = _build.library()
    dev = p.device
    out = torch.zeros((2, ng), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_deposit2(p.data_ptr(), va.data_ptr(), vb.data_ptr(),
                                 out[0].data_ptr(), out[1].data_ptr(), n, ng,
                                 int(periodic), _blocks(n, dev), _THREADS,
                                 _stream(dev))
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
