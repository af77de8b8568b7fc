"""Fixed-point iteration accelerators for the Picard field loop (the
counterpart of ``pypic_tpu/ops/accel.py``).

These change only the iterate update; the fixed point and the residual
test are untouched, so a tolerance means the same thing with or without
acceleration. ``anderson_mix`` is Anderson(1) (secant) mixing:
es_{k+1} = g_k - gamma (g_k - g_{k-1}) with the least-squares
gamma = <df, f_k>/<df, df>; ``anderson2_mix`` keeps two histories and
``anderson_m_mix`` M of them in ring buffers (Walker & Ni 2011).
``finalize_field`` picks the field of the implicit engines' finalize
sweep from the last Picard map outputs (JAX's ``finalize_field``).

The iteration count ``k`` is a host integer here (the Picard loop runs on
the host), so its tests are Python branches; the inner products, the
small solves and their safeguards stay on the device and read nothing
back. ``reduce`` (the counterpart of JAX's ``psum_axis``) sums each inner
product over the ranks that hold the slabs of a slab-sharded field, so
mixing the slabs equals mixing the global field; None for a field held
whole.
"""

from __future__ import annotations

import torch


def mix_init(e0: torch.Tensor, mode):
    """Initial accelerator carry. ``mode``: False/None/'none'/'damped' ->
    (), True/'anderson' -> (g_prev, f_prev), 'anderson2' -> (g_prev,
    g_prev2, f_prev, f_prev2), 'andersonM' (M > 2, e.g. 'anderson5') ->
    (g_hist, f_hist) ring buffers of M + 1 rows."""
    if mode in (False, None, "none", "damped"):
        return ()
    if mode in (True, "anderson"):
        return (torch.zeros_like(e0), torch.zeros_like(e0))
    if mode == "anderson2":
        return tuple(torch.zeros_like(e0) for _ in range(4))
    m = anderson_depth(mode)
    if m is not None:
        z = torch.zeros((m + 1,) + tuple(e0.shape), dtype=e0.dtype,
                        device=e0.device)
        return (z, z.clone())
    raise ValueError(f"unknown accelerator mode {mode!r}")


def anderson_depth(mode):
    """Parse 'andersonM' -> M (int), else None ('anderson'/'anderson2'
    keep their dedicated implementations)."""
    if isinstance(mode, str) and mode.startswith("anderson"):
        tail = mode[len("anderson"):]
        if tail.isdigit() and int(tail) > 2:
            return int(tail)
    return None


def damped_mix(es, eh, k: int, aux):
    """Under-relaxed fixed point es_{k+1} = (es_k + eh_k)/2: same fixed
    point."""
    return 0.5 * (es + eh), aux


def anderson_mix(es, eh, k: int, aux, reduce=None):
    """One Anderson(1) update. Returns (es_next, new_aux).

    Plain fixed point on the first iteration and on a degenerate secant;
    the step-size clip keeps a noisy f32 residual from extrapolating wildly
    inside the round-off noise ball. ``reduce`` (the counterpart of JAX's
    ``psum_axis``) sums each secant inner product over the ranks that hold
    the slabs of a slab-sharded field, so mixing the slabs equals mixing
    the global field; None for a field held whole.
    """
    if aux == ():
        return eh, aux
    g_prev, f_prev = aux
    f = eh - es
    df = f - f_prev

    def _sum(x):
        s = torch.sum(x)
        return s if reduce is None else reduce(s)

    denom = _sum(df * df)
    ok = denom > 0
    gamma = _sum(df * f) / torch.where(ok, denom, 1.0)
    gamma = torch.where(ok, torch.clamp(gamma, -5.0, 5.0), 0.0)
    es_next = eh - gamma * (eh - g_prev) if k > 0 else eh
    return es_next, (eh, f)


def _summer(reduce):
    def _sum(x, dims=None):
        s = torch.sum(x) if dims is None else torch.sum(x, dim=dims)
        return s if reduce is None else reduce(s)
    return _sum


def anderson2_mix(es, eh, k: int, aux, reduce=None):
    """One Anderson(2) update (two-history least squares). Returns
    (es_next, new_aux) with aux = (g_prev, g_prev2, f_prev, f_prev2).

    Solves the 2x2 normal equations for gamma minimizing
    ||f_k - [df1 df2] gamma|| with df1 = f_k - f_{k-1},
    df2 = f_{k-1} - f_{k-2}, then
    es_next = g_k - g1 (g_k - g_{k-1}) - g2 (g_{k-1} - g_{k-2}).
    Safeguards: plain fixed point at k == 0, the one-history secant at
    k == 1 and on a near-singular system (det <= 1e-8 a11 a22), the steps
    clipped to [-5, 5]."""
    if aux == ():
        return eh, aux
    g1p, g2p, f1p, f2p = aux
    f = eh - es
    df1 = f - f1p
    df2 = f1p - f2p
    _sum = _summer(reduce)
    a11 = _sum(df1 * df1)
    a12 = _sum(df1 * df2)
    a22 = _sum(df2 * df2)
    b1 = _sum(df1 * f)
    b2 = _sum(df2 * f)
    det = a11 * a22 - a12 * a12
    # conditioning guard: collinear histories count as singular
    ok2 = det > 1e-8 * torch.clamp(a11 * a22, min=1e-30)
    inv_det = 1.0 / torch.where(ok2, det, 1.0)
    c1 = torch.clamp(torch.where(ok2, (a22 * b1 - a12 * b2) * inv_det, 0.0),
                     -5.0, 5.0)
    c2 = torch.clamp(torch.where(ok2, (a11 * b2 - a12 * b1) * inv_det, 0.0),
                     -5.0, 5.0)
    # the Anderson(1) fallback (k == 1, or a singular 2-history system)
    pos = a11 > 0
    g1_only = _sum(df1 * f) / torch.where(pos, a11, 1.0)
    g1_only = torch.where(pos, torch.clamp(g1_only, -5.0, 5.0), 0.0)
    es_a1 = eh - g1_only * (eh - g1p)
    if k >= 2:
        es_a2 = eh - c1 * (eh - g1p) - c2 * (g1p - g2p)
        es_next = torch.where(ok2, es_a2, es_a1)
    elif k == 1:
        es_next = es_a1
    else:
        es_next = eh
    return es_next, (eh, g1p, f, f1p)


def anderson_m_mix(es, eh, k: int, aux, m: int, reduce=None,
                   reg: float = 1e-8):
    """One Anderson(m) update over ring-buffered histories. Returns
    (es_next, new_aux) with aux = (g_hist, f_hist), each (m + 1,) +
    es.shape, row 0 the newest after the update.

    Solves the Tikhonov-regularized normal equations for the least-squares
    combination of the last min(k, m) residual differences (histories
    beyond k masked out, so k == 0 is the plain fixed point and k == 1 the
    secant). The (m, m) solve is ``torch.linalg.solve_ex`` on the device
    (no host read); a non-finite solution falls back to 0, the
    coefficients clip to [-5, 5] and the correction is capped at 10x the
    residual norm (the map is only piecewise smooth)."""
    if aux == ():
        return eh, aux
    g_hist, f_hist = aux
    f = eh - es
    _sum = _summer(reduce)
    # at entry row j holds iteration k-1-j: dG_0 = g_k - g_{k-1} from the
    # current (eh, f), dG_j = g_{k-j} - g_{k-j-1} below it
    dg = torch.cat([(eh - g_hist[0])[None], g_hist[:m - 1] - g_hist[1:m]])
    df = torch.cat([(f - f_hist[0])[None], f_hist[:m - 1] - f_hist[1:m]])
    valid = (torch.arange(m, device=es.device) < k).to(es.dtype)
    shape = (m,) + (1,) * (df.dim() - 1)
    df = df * valid.reshape(shape)
    dg = dg * valid.reshape(shape)
    red = tuple(range(1, df.dim()))
    a = _sum(df[:, None] * df[None, :], tuple(d + 1 for d in red))  # (m, m)
    b = _sum(df * f[None], red)  # (m,)
    scale = torch.clamp(torch.max(torch.diagonal(a)), min=1e-30)
    a = a + (reg * scale + 1e-30) * torch.eye(m, dtype=a.dtype,
                                              device=a.device)
    gamma = torch.linalg.solve_ex(a, b)[0]
    gamma = torch.where(torch.isfinite(gamma), gamma, 0.0)
    gamma = torch.clamp(gamma, -5.0, 5.0)
    delta = torch.tensordot(gamma, dg, dims=1)
    dn = torch.sqrt(_sum(delta * delta))
    fn = torch.sqrt(_sum(f * f))
    cap = 10.0 * fn
    delta = delta * torch.where(dn > cap, cap / torch.clamp(dn, min=1e-30),
                                1.0)
    es_next = eh - delta if k > 0 else eh
    g_hist = torch.cat([eh[None], g_hist[:-1]])
    f_hist = torch.cat([f[None], f_hist[:-1]])
    return es_next, (g_hist, f_hist)


def finalize_field(ef_last, hist, k, mode: str, reduce=None):
    """The field the finalize sweep gathers (JAX's ``finalize_field``):
    ``ef_last`` (the iterate after the last mix) for 'last'; else from
    the map-output history ``hist`` = (eh_k, eh_{k-1}[, eh_{k-2}]) after
    ``k`` passes (a host int, or a 0-d tensor where the loop counts its
    passes on the device). 'mean2' falls back to eh_k at k == 1
    (eh_{k-1} is then the seed, not a map output); 'aitken' needs k > 2
    and a nonzero second difference, and clips its ratio to +-0.95.
    ``reduce`` sums the aitken inner products over the slabs of a
    slab-sharded field."""
    if mode == "last":
        return ef_last
    eh = hist[0]
    if mode == "map":
        return eh
    if mode == "mean2":
        if isinstance(k, torch.Tensor):
            return torch.where(k > 1, 0.5 * (eh + hist[1]), eh)
        return 0.5 * (eh + hist[1]) if k > 1 else eh
    d1 = eh - hist[1]
    d2 = hist[1] - hist[2]
    den = torch.sum(d2 * d2)
    num = torch.sum(d1 * d2)
    if reduce is not None:
        den, num = reduce(torch.stack([den, num])).unbind(0)
    trust = den > 0.0
    rho = torch.clamp(num / torch.where(trust, den, 1.0), -0.95, 0.95)
    if isinstance(k, torch.Tensor):
        trust = trust & (k > 2)
    elif k <= 2:
        return eh
    corr = (rho / (1.0 - rho)) * d1
    return eh + torch.where(trust, corr, torch.zeros_like(corr))


def keep_history(mode: str, emit_v: bool) -> int:
    """How many Picard map outputs ``finalize_field`` needs (0, 2 or 3)."""
    if emit_v or mode == "last":
        return 0
    return 3 if mode == "aitken" else 2
