"""CUDA particle kernels of the domain-decomposed engines and their plain
versions.

The counterparts of the ``pypic_tpu/ops/pallas_cic.py`` kernels that
``pypic_tpu/parallel/domain_implicit.py`` and ``parallel/domain.py``
reach:

* ``picard_iteration_ext``       — ``picard_iteration_ext_pallas`` (one
  Picard pass of a slab on its halo-extended field; ``shared=True`` the
  shared-window variant, its frame's clamps counted);
* ``picard_finalize_ext_nodep``  — ``picard_finalize_ext_nodep_pallas``
  in stats mode (the converged finalize sweep of a slab: global wrap and
  the step statistics);
* ``picard_finalize_ext``        — ``picard_finalize_ext_pallas`` in stats
  mode (the same, plus the full-step current on the extended slab,
  finalize='converged-deposit');
* ``leapfrog_gather_push``       — ``leapfrog_gather_push_pallas``
  (periodic gather from the replicated global field, kick-drift-kick,
  wrap);
* ``explicit_domain_cycle``      — ``explicit_domain_cycle_pallas`` (the
  same sweep and the deposit of the new positions onto the halo-extended
  slab, carried_rho='on', clamps counted).

The kernels are in ``pypic_tpu_torch/csrc/domain.cu`` (built by
``_build``). The conventions are ``ops/cuda_cic.py``'s: a wrapper launches
its kernel on CUDA tensors and runs its plain PyTorch version (``*_plain``)
on CPU tensors; anything else raises; a failed build or launch raises and
nothing falls back; ``cuda_cic.LAUNCHES`` counts each wrapper's launches
(``cuda_cic.LARGE_LAUNCHES`` those in a large mode). Each kernel keeps its
arrays in a block's shared memory up to its ceiling and takes the large
modes of ``cuda_cic.smem_mode`` above it, up to ``cuda_cic.LARGE_MAX_NG``
nodes (a limit checked in the CUDA branch only); the slab pass chooses
through ``cuda_cic.cluster_launch``, whose cluster and pair modes it
shares with rows 1, 2 and 14 (``cuda_cic.PASS_RULE``).

The slab forms differ from the periodic kernels of ``cuda_cic``: the field
is a bounded extended slab of ext_n = c + 2 hw + 1 nodes (no wrap), the
deposit weight ``w`` is per particle (zero in dead slots), and positions
are clamped to [lo, hi] for the gather and the deposit while the raw
iterate is returned.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, cuda_cic
from .cic import cic_indices_weights
from .cuda_cic import (SMEM_MODES, _check_1d, _check_ng, _count, _device_kind,
                       _inv, _leapfrog, _pass_sum, _stream, _sweep, _wrap,
                       check_large_ng, deposit_plain, gather_plain, kernel_scalars,
                       leapfrog_scalars, mode_sum_plain, window_sw)


def _f32(x) -> float:
    return float(np.float32(x))


def _frame(ext_n: int):
    """(stride, width, K, float32 1/stride) of the shared-window frame of
    an ext_n-node slab (``cuda_cic.window_sw``)."""
    stride, width = window_sw(ext_n)
    return stride, width, (ext_n - 1) // stride + 1, _f32(1.0 / stride)


def _cn(field_ext, ps, p0, v0, qm, dt, dx, lo, hi):
    """Gather at clamp(ps, lo, hi) from the bounded slab field, then the CN
    push in the kernels' operation order: (clamped ps, p1, v1)."""
    qm_dt, qm_dt2_half, dt_dx, _ = kernel_scalars(qm, dt, dx, 0.0)
    s = torch.clamp(ps, lo, hi)
    e_p = gather_plain(field_ext, s, periodic=False)
    return s, p0 + dt_dx * v0 + qm_dt2_half * e_p, v0 + qm_dt * e_p


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ext_terms(field_ext, ps, p0, v0, w, qm, dt, dx, lo, hi, shared):
    """The slab pass's rows as its kernel computes them: (ph, v1, left
    node, left term, right term, clamped), the left node in [0, ext_n - 2]
    with the separate window and in [-1, ext_n - 1] (or beyond: both
    nodes outside) with the shared one, the right node left + 1, the
    clamp count an int32 (0 without ``shared``)."""
    ext_n = field_ext.shape[0]
    s, p1, v1 = _cn(field_ext, ps, p0, v0, qm, dt, dx, lo, hi)
    ph = 0.5 * (p0 + p1)
    vals = w * (0.5 * (v0 + v1))
    hc = torch.clamp(ph, lo, hi)
    if not shared:
        il, _, wl, wr = cic_indices_weights(hc, ext_n - 1, False)
        return ph, v1, il, vals * wl, vals * wr, torch.zeros((), dtype=torch.int32)
    stride, width, num_k, inv_stride = _frame(ext_n)
    k = torch.clamp((torch.floor(s) * inv_stride).to(torch.int32), 0, num_k - 1)
    d_h = ((s - k.to(s.dtype) * stride) + 1.0) + (hc - s)
    oob = ((d_h < 0.0) | (d_h > width - 1.0)) & (w != 0.0)
    d_h = torch.clamp(d_h, 0.0, width - 1.0)
    row = torch.clamp(torch.floor(d_h).to(torch.int64), max=width - 2)
    wr = d_h - row.to(d_h.dtype)
    left = stride * k.to(torch.int64) + row - 1
    return ph, v1, left, vals * (1.0 - wr), vals * wr, oob.sum().to(torch.int32)


def picard_iteration_ext_cluster_plain(field_ext, ps, p0, v0, w, *, qm, dt: float,
                                       dx: float, lo: float, hi: float,
                                       emit_v: bool = False, shared: bool = False,
                                       mode: str = "cluster", cluster: int = 1):
    """The slab pass's cluster or pair mode on any device:
    ``picard_iteration_ext_plain``'s ph, v1 and clamp count, jh summed as
    ``cuda_cic.mode_sum_plain`` sums the kernel's terms on the bounded slab
    in ``mode`` over ``cluster`` CTAs (the products at nodes outside [0,
    ext_n) dropped). Returns what ``picard_iteration_ext_plain`` returns."""
    ext_n = field_ext.shape[0]
    ph, v1, left, t_left, t_right, n_clamped = _ext_terms(
        field_ext, ps, p0, v0, w, qm, dt, dx, lo, hi, shared)
    jh = mode_sum_plain(mode, left, left + 1, t_left, t_right, ext_n, cluster,
                        bounded=True)
    res = (ph,) + ((v1,) if emit_v else ()) + (jh,)
    return res + ((n_clamped,) if shared else ())


def picard_iteration_ext_plain(field_ext, ps, p0, v0, w, *, qm, dt: float,
                               dx: float, lo: float, hi: float,
                               emit_v: bool = False, shared: bool = False,
                               acc_dtype=None):
    """One Picard pass on the extended slab. Returns (ph, jh), (ph, v1, jh)
    with ``emit_v``, and a trailing int32 clamp count with ``shared``.
    ``acc_dtype`` is the dtype jh is summed in (float32 by default; float64
    sums the same float32 terms into a reference)."""
    ext_n = field_ext.shape[0]
    if not shared:
        _, p1, v1 = _cn(field_ext, ps, p0, v0, qm, dt, dx, lo, hi)
        ph = 0.5 * (p0 + p1)
        vals = w * (0.5 * (v0 + v1))
        jh = deposit_plain(torch.clamp(ph, lo, hi), vals.to(acc_dtype or vals.dtype),
                           ext_n, periodic=False)
        return (ph, v1, jh) if emit_v else (ph, jh)
    # the midpoint's row in the gather's window frame (pallas_cic.py
    # _window_decompose, _shared_gather and _picard_iter_ext_sw_kernel)
    ph, v1, left, t_left, t_right, n_clamped = _ext_terms(
        field_ext, ps, p0, v0, w, qm, dt, dx, lo, hi, True)
    acc = acc_dtype or t_left.dtype
    jh = torch.zeros((ext_n,), dtype=acc, device=t_left.device)
    for node, part in ((left, t_left), (left + 1, t_right)):
        inside = (node >= 0) & (node < ext_n)  # the TPU fold drops the rest
        jh.index_add_(0, torch.clamp(node, 0, ext_n - 1),
                      torch.where(inside, part, 0.0).to(acc))
    return (ph, v1, jh, n_clamped) if emit_v else (ph, jh, n_clamped)


def ext_stats_plain(p1_raw, v1, w, lo: float, hi: float) -> torch.Tensor:
    """The finalize's statistics as a float64 (3,) tensor: sum w v1, sum
    over live slots (w != 0) of v1^2, and the live slots whose raw p1 lies
    outside [lo, hi]; each term a float32 product, summed in float64."""
    alive = w != 0.0
    return torch.stack([
        (w * v1).double().sum(),
        torch.where(alive, v1 * v1, 0.0).double().sum(),
        (alive & ((p1_raw < lo) | (p1_raw > hi))).double().sum()])


def picard_finalize_ext_plain(field_ext, ps, p0, v0, w, *, qm, dt: float,
                              dx: float, lo: float, hi: float,
                              lo_shift: float, ng: int,
                              deposit: bool = False, acc_dtype=None):
    """The converged finalize on the extended slab, stats mode: (p1, v1,
    stats), or (p1, v1, j1, stats) with ``deposit``. p1 is the raw
    position plus ``lo_shift``, wrapped to [0, ng) when ng > 0."""
    ext_n = field_ext.shape[0]
    _, p1, v1 = _cn(field_ext, ps, p0, v0, qm, dt, dx, lo, hi)
    stats = ext_stats_plain(p1, v1, w, lo, hi)
    pg = p1 + _f32(lo_shift)
    if ng > 0:
        pg = _wrap(pg, ng)
    if not deposit:
        return pg, v1, stats
    acc = acc_dtype or v1.dtype
    j1 = deposit_plain(torch.clamp(p1, lo, hi), (w * v1).to(acc), ext_n,
                       periodic=False)
    return pg, v1, j1, stats


def leapfrog_gather_push_plain(field, p, v, *, qm, dt: float, dx: float):
    """Periodic gather, kick-drift-kick and wrap, the wrap's result then
    taken mod ng as the engine's step does: (p1, v1)."""
    qmh, dt_dx, _ = leapfrog_scalars(qm, dt, dx, 0.0)
    ng = field.shape[0]
    p1, v1 = _leapfrog(field, p, v, qmh, dt_dx, ng)
    return torch.remainder(p1, ng), v1


def explicit_domain_cycle_plain(field, p, v, w, *, qm, dt: float, dx: float,
                                lo_shifted: float, ext_n: int,
                                acc_dtype=None):
    """``leapfrog_gather_push_plain`` and the deposit of w at the raw new
    position onto the (ext_n,) extended slab at p1 - lo_shifted, clamped
    to [0, ext_n - 1] (the live rows, w != 0, that clamp counted):
    (p1, v1, rho_ext, n_clamped). ``acc_dtype`` is the dtype rho_ext is
    summed in (float32 by default; float64 sums the same float32 terms
    into a reference)."""
    qmh, dt_dx, _ = leapfrog_scalars(qm, dt, dx, 0.0)
    ng = field.shape[0]
    kick = qmh * gather_plain(field, p, periodic=True)
    vh = v + kick
    raw = p + vh * dt_dx
    ploc = raw - _f32(lo_shifted)
    top = float(ext_n - 1)
    n_clamped = ((w != 0.0) & ((ploc < 0.0) | (ploc > top))).sum(
        dtype=torch.int32)
    il, ir, wl, wr = cic_indices_weights(torch.clamp(ploc, 0.0, top),
                                         ext_n - 1, False)
    acc = acc_dtype or w.dtype
    rho_ext = torch.zeros((ext_n,), dtype=acc, device=w.device)
    rho_ext.index_add_(0, il, (w * wl).to(acc))
    rho_ext.index_add_(0, ir, (w * wr).to(acc))
    return (torch.remainder(_wrap(raw, ng), ng), vh + kick, rho_ext,
            n_clamped)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_slab(name, field_ext, ps, p0, v0, w):
    kind = _device_kind((field_ext, ps, p0, v0, w), name)
    ext_n = field_ext.shape[0] if field_ext.dim() == 1 else -1
    _check_1d("field_ext", field_ext, ext_n)
    _check_ng(ext_n)
    n = ps.shape[0] if ps.dim() == 1 else -1
    for name, t in (("ps", ps), ("p0", p0), ("v0", v0), ("w", w)):
        _check_1d(name, t, n)
    return kind, n, ext_n


def picard_iteration_ext(field_ext, ps, p0, v0, w, *, qm, dt: float,
                         dx: float, lo: float, hi: float,
                         emit_v: bool = False, shared: bool = False,
                         active=None, out=None):
    """One Picard pass of a slab. Returns (ph, jh) — the raw half-step
    positions and the (ext_n,) half-step current on the extended slab —
    (ph, v1, jh) with ``emit_v``, and a trailing int32 count of deposits
    clamped at the window frame's edge with ``shared``.

    ``out``: (ph buffer, v1 buffer or None) to write into; ph may alias
    ``ps``. ``active`` (needs ``out``): a one-element int32 tensor on the
    particles' device; when it holds 0 the pass writes nothing, jh is zero
    and the count 0, so a Picard loop can run a fixed number of passes
    without reading the residual on the host.

    On the card its mode is ``cuda_cic.cluster_launch``'s (PASS_RULE, the
    kernel "picard_iteration_ext" or "picard_iteration_ext shared")."""
    kind, n, ext_n = _check_slab("picard_iteration_ext", field_ext, ps, p0, v0, w)
    if active is not None:
        if out is None:
            raise ValueError("active needs out: a skipped pass leaves the "
                             "output buffers as they were")
        if (active.dtype != torch.int32 or active.numel() != 1
                or active.device != ps.device):
            raise ValueError("active must be one int32 on the particles' "
                             "device")
    if out is not None:
        _device_kind((ps,) + tuple(b for b in out if b is not None),
                     "picard_iteration_ext")
        _check_1d("out[0]", out[0], n)
        if emit_v:
            _check_1d("out[1]", out[1], n)
    if kind == "cpu":
        if active is not None and not bool(active.reshape(-1)[0]):
            jh = torch.zeros((ext_n,), dtype=ps.dtype)
            res = (out[0],) + ((out[1],) if emit_v else ()) + (jh,)
            return res + ((torch.zeros((), dtype=torch.int32),) if shared else ())
        res = picard_iteration_ext_plain(field_ext, ps, p0, v0, w, qm=qm,
                                         dt=dt, dx=dx, lo=lo, hi=hi,
                                         emit_v=emit_v, shared=shared)
        if out is None:
            return res
        out[0].copy_(res[0])
        if emit_v:
            out[1].copy_(res[1])
        return (out[0],) + ((out[1],) if emit_v else ()) + res[1 + emit_v:]
    dev = ps.device
    kernel = "picard_iteration_ext shared" if shared else "picard_iteration_ext"
    launch = cuda_cic._pass_launch(dev, kernel, n, ext_n, 4, emit_v)
    lib = _build.library()
    qm_dt, qm_dt2_half, dt_dx, _ = kernel_scalars(qm, dt, dx, 0.0)
    ph = out[0] if out is not None else torch.empty_like(ps)
    v1 = None
    if emit_v:
        v1 = out[1] if out is not None else torch.empty_like(ps)
    buf = _pass_sum(launch.mode, ext_n, torch.float32, dev, bounded=True)
    ncl = torch.zeros((1,), dtype=torch.int32, device=dev) if shared else None
    stride, width, num_k, inv_stride = _frame(ext_n) if shared else (0, 0, 0, 0.0)
    with torch.cuda.device(dev):
        err = lib.pypic_picard_iteration_ext(
            field_ext.data_ptr(), ps.data_ptr(), p0.data_ptr(), v0.data_ptr(),
            w.data_ptr(), ph.data_ptr(), v1.data_ptr() if emit_v else None,
            buf.data_ptr(), ncl.data_ptr() if shared else None,
            active.data_ptr() if active is not None else None, n, ext_n,
            qm_dt, qm_dt2_half, dt_dx, _f32(lo), _f32(hi), int(shared),
            stride, width, num_k, inv_stride, SMEM_MODES[launch.mode],
            launch.blocks, launch.threads, launch.cluster, _stream(dev))
    _build.check(err, "picard_iteration_ext")
    _count("picard_iteration_ext", launch.mode)
    res = (ph,) + ((v1,) if emit_v else ()) + (buf[-ext_n:],)
    return res + ((ncl[0],) if shared else ())


def _finalize_ext(field_ext, ps, p0, v0, w, deposit: bool, name: str, *,
                  qm, dt, dx, lo, hi, lo_shift, ng):
    kind, n, ext_n = _check_slab("picard_finalize_ext", field_ext, ps, p0, v0, w)
    if ng < 0:
        raise ValueError(f"ng must be >= 0, got {ng}")
    if kind == "cpu":
        return picard_finalize_ext_plain(
            field_ext, ps, p0, v0, w, qm=qm, dt=dt, dx=dx, lo=lo, hi=hi,
            lo_shift=lo_shift, ng=ng, deposit=deposit)
    dev = ps.device
    launch = _sweep(dev, name, n, ext_n)
    lib = _build.library()
    qm_dt, qm_dt2_half, dt_dx, _ = kernel_scalars(qm, dt, dx, 0.0)
    p1 = torch.empty_like(ps)
    v1 = torch.empty_like(ps)
    j1 = (torch.zeros((ext_n,), dtype=torch.float32, device=dev) if deposit
          else None)
    blocks = launch.blocks
    partial = torch.empty((3 * blocks,), dtype=torch.float64, device=dev)
    stats = torch.empty((3,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_picard_finalize_ext(
            field_ext.data_ptr(), ps.data_ptr(), p0.data_ptr(), v0.data_ptr(),
            w.data_ptr(), p1.data_ptr(), v1.data_ptr(),
            j1.data_ptr() if deposit else None, partial.data_ptr(),
            stats.data_ptr(), n, ext_n, qm_dt, qm_dt2_half, dt_dx, _f32(lo),
            _f32(hi), _f32(lo_shift), int(ng), _inv(max(ng, 1)),
            SMEM_MODES[launch.mode], blocks, launch.threads, _stream(dev))
    _build.check(err, name)
    _count(name, launch.mode)
    return (p1, v1, j1, stats) if deposit else (p1, v1, stats)


def picard_finalize_ext_nodep(field_ext, ps, p0, v0, w, *, qm, dt: float,
                              dx: float, lo: float, hi: float,
                              lo_shift: float, ng: int):
    """The converged finalize sweep of a slab without the j1 deposit:
    (p1, v1, stats). p1 = the raw position + ``lo_shift``, wrapped to
    [0, ng) when ng > 0; stats a float64 (3,) tensor: sum w v1, sum over
    live slots of v1^2, halo clamps (``ext_stats_plain``)."""
    return _finalize_ext(field_ext, ps, p0, v0, w, False,
                         "picard_finalize_ext_nodep", qm=qm, dt=dt, dx=dx,
                         lo=lo, hi=hi, lo_shift=lo_shift, ng=ng)


def picard_finalize_ext(field_ext, ps, p0, v0, w, *, qm, dt: float,
                        dx: float, lo: float, hi: float, lo_shift: float,
                        ng: int):
    """``picard_finalize_ext_nodep`` plus the full-step current w v1
    deposited at clamp(p1) onto the extended slab: (p1, v1, j1, stats)."""
    return _finalize_ext(field_ext, ps, p0, v0, w, True,
                         "picard_finalize_ext", qm=qm, dt=dt, dx=dx, lo=lo,
                         hi=hi, lo_shift=lo_shift, ng=ng)


def leapfrog_gather_push(field, p, v, *, qm, dt: float, dx: float):
    """Periodic CIC gather of the (ng,) global field, kick-drift-kick and
    the periodic wrap in one sweep: (p1, v1), p1 equal to
    ``torch.remainder`` of the Pallas kernel's wrapped position (the
    step's mod folded in). ``qm`` is the float32 q/m."""
    kind = _device_kind((field, p, v), "leapfrog_gather_push")
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    _check_ng(ng)
    n = p.shape[0] if p.dim() == 1 else -1
    _check_1d("p", p, n)
    _check_1d("v", v, n)
    if kind == "cpu":
        return leapfrog_gather_push_plain(field, p, v, qm=qm, dt=dt, dx=dx)
    dev = p.device
    launch = _sweep(dev, "leapfrog_gather_push", n, ng)
    lib = _build.library()
    qmh, dt_dx, _ = leapfrog_scalars(qm, dt, dx, 0.0)
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    with torch.cuda.device(dev):
        err = lib.pypic_leapfrog_push(
            field.data_ptr(), p.data_ptr(), v.data_ptr(), p1.data_ptr(),
            v1.data_ptr(), n, ng, qmh, dt_dx, _inv(ng),
            SMEM_MODES[launch.mode], launch.blocks, launch.threads,
            _stream(dev))
    _build.check(err, "leapfrog_gather_push")
    _count("leapfrog_gather_push", launch.mode)
    return p1, v1


def explicit_domain_cycle(field, p, v, w, *, qm, dt: float, dx: float,
                          lo_shifted: float, ext_n: int):
    """The carried-rho explicit domain cycle in one sweep: the periodic
    gather of the (ng,) global field at p, kick-drift-kick, and the
    deposit of the weights ``w`` (0 in dead slots) at the raw new position
    onto this rank's (ext_n,) extended slab, at p1 - ``lo_shifted`` (the
    slab origin less the halo, a float32 value). A deposit off the slab
    clamps to its edge and is counted where w != 0.

    Returns (p1, v1, rho_ext, n_clamped): p1 wrapped with the step's mod
    ng folded in (as ``leapfrog_gather_push``), n_clamped an int32 0-d
    tensor on the particles' device. ``qm`` is the float32 q/m."""
    kind = _device_kind((field, p, v, w), "explicit_domain_cycle")
    ng = field.shape[0] if field.dim() == 1 else -1
    _check_1d("field", field, ng)
    _check_ng(ng)
    _check_ng(ext_n)
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in (("p", p), ("v", v), ("w", w)):
        _check_1d(name, t, n)
    kw = dict(qm=qm, dt=dt, dx=dx, lo_shifted=lo_shifted, ext_n=ext_n)
    if kind == "cpu":
        return explicit_domain_cycle_plain(field, p, v, w, **kw)
    dev = p.device
    check_large_ng(ext_n, "explicit_domain_cycle")
    launch = _sweep(dev, "explicit_domain_cycle", n, ng, extra=4 * ext_n)
    lib = _build.library()
    qmh, dt_dx, _ = leapfrog_scalars(qm, dt, dx, 0.0)
    p1 = torch.empty_like(p)
    v1 = torch.empty_like(v)
    rho_ext = torch.zeros((ext_n,), dtype=torch.float32, device=dev)
    n_clamped = torch.zeros((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pypic_explicit_domain_cycle(
            field.data_ptr(), p.data_ptr(), v.data_ptr(), w.data_ptr(),
            p1.data_ptr(), v1.data_ptr(), rho_ext.data_ptr(),
            n_clamped.data_ptr(), n, ng, int(ext_n), qmh, dt_dx,
            _f32(lo_shifted), _inv(ng), SMEM_MODES[launch.mode],
            launch.blocks, launch.threads, _stream(dev))
    _build.check(err, "explicit_domain_cycle")
    _count("explicit_domain_cycle", launch.mode)
    return p1, v1, rho_ext, n_clamped
