"""Diagnostics: rate fits over metric time series (the counterpart of
``pypic_tpu/diagnostics.py`` ``growth_rate_from_energy`` and
``damping_rate_from_peaks``) and the comparison of two runs' Picard
counts. numpy in, numpy out; a tensor argument is copied to the host
first.
"""

from __future__ import annotations

import numpy as np


def _as_f64(series) -> np.ndarray:
    if hasattr(series, "detach"):
        series = series.detach().cpu().numpy()
    return np.asarray(series, np.float64)


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
