"""Diagnostics (the counterpart of ``pypic_tpu/diagnostics.py``):

* ``first_peak_index``, ``growth_rate_from_energy``,
  ``damping_rate_from_peaks``: analysis of metric time series (numpy in,
  numpy out; a tensor argument is copied to the host first);
* ``phase_space_histogram`` / ``velocity_histogram``: the summary plot's
  reductions (pypic.py:583, 592) on the tensors' device, with the bins of
  ``jnp.histogram2d`` and ``jnp.histogram``; the counts go through
  ``ops.cic.histogram_add`` (row 4's deposit kernel on the card);
* ``write_run_outputs``: the end-of-run text dumps E2.txt, J.txt and
  parameters.out (pypic.py:637-648);
* ``picard_counts_agree``, ``floor_exit_counts_agree``: the comparison of
  two runs' Picard counts.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# float32 counts are exact while every bin holds fewer than 2^24: a sum at
# 2^24 may already have rounded (2^24 + 1 reads 2^24)
EXACT_COUNT = 2 ** 24


def _as_f64(series) -> np.ndarray:
    if hasattr(series, "detach"):
        series = series.detach().cpu().numpy()
    return np.asarray(series, np.float64)


def first_peak_index(energy, dt: float) -> int:
    """Index of the first local maximum of a time series (pypic.py:599-611:
    sign change of the centered time derivative with positive left slope)."""
    e = _as_f64(energy)
    de = np.gradient(e, dt)
    prod = de[1:] * de[:-1]
    for s in range(len(prod)):
        if prod[s] < 0.0 and de[s] > 0.0:
            return s + 1
    return 0


def growth_rate_from_energy(energy, dt: float, saturation_frac: float = 0.5):
    """Growth rate gamma with E^2 ~ exp(2 gamma t): from the pre-growth
    minimum to the half-saturation crossing."""
    e = _as_f64(energy)
    i1 = int(np.argmax(e > saturation_frac * e.max()))
    i0 = int(np.argmin(e[:max(i1, 2)]))
    if i1 - i0 < 2:
        raise ValueError(f"no growth window found: [{i0}, {i1}]")
    return np.log(e[i1] / e[i0]) / (2.0 * (i1 - i0) * dt)


def damping_rate_from_peaks(energy, dt: float, t_max: float | None = None,
                            floor_mult: float = 5.0):
    """Damping rate from the peak envelope of an oscillating E^2 decay
    (E^2 oscillates at 2 w_pe during Landau damping)."""
    e = _as_f64(energy)
    floor = e.min() * floor_mult
    peaks = [
        i for i in range(2, len(e) - 2)
        if e[i] > e[i - 1] and e[i] >= e[i + 1] and e[i] > floor
    ]
    t = np.arange(len(e)) * dt
    if t_max is not None:
        peaks = [i for i in peaks if t[i] < t_max]
    if len(peaks) < 3:
        raise ValueError(f"only {len(peaks)} envelope peaks found")
    return np.polyfit(t[peaks], np.log(e[peaks]), 1)[0] / 2.0


def _edges(lo, hi, bins: int, device) -> torch.Tensor:
    """float32 bin edges as JAX's ``jnp.linspace`` gives them on the CPU
    for a float32 sample: XLA folds the division by bins into a float32
    reciprocal r and contracts the last multiply-add, so edge i is
    fma(i, hi r, lo (1 - i r)) (the fused add done here in float64, where
    the product is exact), and the last edge is hi itself. An edge may
    still differ from JAX's in its last bit where XLA's vector code orders
    the operations otherwise (1 in 50 random ranges, at the second edge)."""
    f32 = dict(dtype=torch.float32, device=device)
    lo, hi = torch.tensor(float(lo), **f32), torch.tensor(float(hi), **f32)
    r = torch.tensor(1.0, **f32) / torch.tensor(float(bins), **f32)
    i = torch.arange(bins, **f32)
    inner = (i.double() * (hi * r).double()
             + (lo * (1.0 - i * r)).double()).to(torch.float32)
    return torch.cat([inner, hi.reshape(1)])


def _bin_index(a: torch.Tensor, edges: torch.Tensor):
    """numpy's rule: bin k holds edges[k] <= a < edges[k + 1], the last bin
    is closed on the right, and a value outside the range is dropped.
    Returns (bin clipped into range, kept mask)."""
    bins = edges.shape[0] - 1
    k = torch.searchsorted(edges, a, right=True) - 1
    k = torch.where(a == edges[-1], bins - 1, k)
    keep = (k >= 0) & (k < bins)
    return torch.clamp(k, 0, bins - 1), keep


def _counts(idx: torch.Tensor, keep: torch.Tensor, nbins: int) -> torch.Tensor:
    """float32 counts of the kept indices by ``histogram_add``; raises when
    a bin may have passed the exact range (checked by one host read, and
    only when there are EXACT_COUNT inputs or more)."""
    from .ops.cic import histogram_add

    h = histogram_add(idx, keep.to(torch.float32), nbins)
    if idx.numel() >= EXACT_COUNT and float(h.max()) >= EXACT_COUNT:
        raise OverflowError(
            f"a bin holds {float(h.max()):.0f} counts: float32 counts are "
            f"exact only below {EXACT_COUNT}")
    return h


def phase_space_histogram(p, v, ng_x: int, nv: int, x_range, v_range):
    """2D (x, v) histogram, the reference's hist2d panel (pypic.py:583):
    (counts (ng_x, nv) float32, x edges, v edges), all on p's device, with
    the bins of ``jnp.histogram2d(p, v, bins=(ng_x, nv), range=...)``."""
    p = torch.as_tensor(p).to(torch.float32).reshape(-1)
    v = torch.as_tensor(v, device=p.device).to(torch.float32).reshape(-1)
    xe = _edges(*x_range, ng_x, p.device)
    ve = _edges(*v_range, nv, p.device)
    ix, keep_x = _bin_index(p, xe)
    iv, keep_v = _bin_index(v, ve)
    h = _counts(ix * nv + iv, keep_x & keep_v, ng_x * nv)
    return h.reshape(ng_x, nv), xe, ve


def velocity_histogram(v, bins: int, v_range):
    """(counts (bins,) float32, edges) on v's device, with the bins of
    ``jnp.histogram(v, bins=bins, range=v_range)``."""
    v = torch.as_tensor(v).to(torch.float32).reshape(-1)
    edges = _edges(*v_range, bins, v.device)
    k, keep = _bin_index(v, edges)
    return _counts(k, keep, bins), edges


def write_run_outputs(directory: str, energy, current, params: dict):
    """End-of-run text dumps (pypic.py:637-648): E2.txt, J.txt,
    parameters.out."""
    os.makedirs(directory, exist_ok=True)
    np.savetxt(os.path.join(directory, "E2.txt"), np.asarray(energy))
    np.savetxt(os.path.join(directory, "J.txt"), np.asarray(current))
    with open(os.path.join(directory, "parameters.out"), "w") as f:
        for key, value in params.items():
            print(key, value, file=f)


def picard_counts_agree(iters_a, resid_a, iters_b, resid_b,
                        tol: float) -> tuple[bool, list[str]]:
    """Whether two runs of one implicit configuration took the same Picard
    passes step for step, but at steps whose residual sat at the threshold.

    Two runs that sum the same deposits in other orders (float atomics,
    another reduction) end a pass with slightly different residuals
    r = sum((es - eh)^2), and a step whose r lands within that difference
    of ``tol`` leaves the loop one pass earlier in one run than in the
    other. The difference is measured, not assumed: sigma is the largest gap
    |sqrt(r_a) - sqrt(r_b)| of the residual norms at the steps where both
    runs took the same passes (a change of eh moves ||es - eh|| by at most
    its own norm). A step whose counts differ is accepted only when they
    differ by one pass and the run that stopped first stopped at a residual
    norm within 2 sigma below sqrt(tol); with no step of equal counts,
    sigma is 0 and every difference is refused.

    ``tol`` is the float32 threshold the loops compared with. Returns (ok,
    lines): a line with sigma, then one for each step whose counts differ,
    with both residuals.
    """
    ia, ib = (_as_f64(x).astype(np.int64) for x in (iters_a, iters_b))
    ra, rb = _as_f64(resid_a), _as_f64(resid_b)
    same = ia == ib
    sigma = float(np.abs(np.sqrt(ra[same]) - np.sqrt(rb[same])).max(initial=0.0))
    root = np.sqrt(float(tol))
    ok = True
    lines = [f"sigma {sigma:.3e} over {int(same.sum())} equal-count steps of "
             f"{len(ia)}, sqrt(tol) {root:.3e}"]
    for s in np.flatnonzero(~same):
        first = ra[s] if ia[s] < ib[s] else rb[s]
        gap = root - np.sqrt(first)
        fine = bool(abs(int(ia[s]) - int(ib[s])) == 1 and 0.0 <= gap <= 2.0 * sigma)
        ok = ok and fine
        lines.append(
            f"step {s}: passes {ia[s]} vs {ib[s]}, residuals {ra[s]:.6e} vs "
            f"{rb[s]:.6e} (tol {tol:.6e}); sqrt(tol) - sqrt(r) of the first "
            f"to stop {gap:.3e}, 2 sigma {2.0 * sigma:.3e}: "
            + ("at the threshold" if fine else "NOT at the threshold"))
    return ok, lines


def floor_exit_counts_agree(iters_a: int, resid_a: float, iters_b: int,
                            resid_b: float, e0, e1, *, tol: float,
                            tol_floor: float) -> tuple[bool, str]:
    """Whether two runs of one sheath step (engines/sheath.py) took the
    same Picard passes, but where the floor exit decided.

    The sheath loop also stops once the residual ||es - eh|| falls below
    tol_floor eps ||es|| (eps of float32): the scale of one summation
    order's round-off. Two runs that sum in other orders may then leave a
    pass apart. A one-pass difference is accepted when the run that
    stopped first left by the floor exit: its residual above ``tol`` and
    at most the threshold, with ||es|| taken as ||eh||, eh = (e0 + e1)/2
    the converged half-step field (within r of es: 1% of room). ``e0``
    and ``e1`` are the step's start and end fields. Returns (ok, line)."""
    ka, kb = int(iters_a), int(iters_b)
    resid_a, resid_b = float(resid_a), float(resid_b)
    if ka == kb:
        return True, f"{ka} passes on both (residuals {resid_a:.4e}, {resid_b:.4e})"
    eh = 0.5 * (_as_f64(e0) + _as_f64(e1))
    floor = tol_floor * float(np.finfo(np.float32).eps) * float(np.linalg.norm(eh))
    first = float(resid_a if ka < kb else resid_b)
    ok = abs(ka - kb) == 1 and tol < first <= 1.01 * floor
    return ok, (f"passes {ka} vs {kb}; the first to stop at r = {first:.6e}, "
                f"floor threshold {floor:.6e}: "
                + ("a floor exit" if ok else "NOT a floor exit one pass apart"))
