"""Fixed-point iteration accelerators for the Picard field loop (the
counterpart of ``pypic_tpu/ops/accel.py``).

These change only the iterate update; the fixed point and the residual
test are untouched, so a tolerance means the same thing with or without
acceleration. ``anderson_mix`` is Anderson(1) (secant) mixing:
es_{k+1} = g_k - gamma (g_k - g_{k-1}) with the least-squares
gamma = <df, f_k>/<df, df>. ``anderson2_mix`` and ``anderson_m_mix`` come
with the options that use them.

The iteration count ``k`` is a host integer here (the Picard loop runs on
the host), so its test is a Python branch; the inner products stay on the
device.
"""

from __future__ import annotations

import torch


def mix_init(e0: torch.Tensor, mode: str):
    """Initial accelerator carry. ``mode``: 'none'/'damped' -> (),
    'anderson' -> (g_prev, f_prev)."""
    if mode in ("none", "damped"):
        return ()
    if mode == "anderson":
        return (torch.zeros_like(e0), torch.zeros_like(e0))
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
