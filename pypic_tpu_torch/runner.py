"""Time-loop runner (the counterpart of ``pypic_tpu/runner.py``).

Replaces the reference's ``for t in range(T)`` driver loops
(pypic.py:557-635). PyTorch runs eagerly, so the loop is a Python loop;
per-step metrics come back stacked as (T,) tensors on the state's device
for offline diagnostics; ``run_thinned`` keeps every scalar row and thins
the heavy ones.
"""

from __future__ import annotations

from typing import Callable

import torch


def run(step_fn: Callable, state, num_steps: int):
    """Apply ``step_fn`` (state -> (state, metrics)) num_steps times.

    Returns:
        (final_state, metrics) with every metric field stacked along a
        leading (num_steps,) axis, on the device the step left it on.
    """
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    rows = []
    for _ in range(num_steps):
        state, metrics = step_fn(state)
        rows.append(metrics)
    stacked = type(rows[0])(*(torch.stack(col) for col in zip(*rows)))
    return state, stacked


def run_thinned(step_fn: Callable, state, num_steps: int, every: int):
    """Like ``run``, but the *heavy* (non-0-d) metrics keep only the last
    row of each chunk of ``every`` steps; scalar metrics keep every step.

    The reference's split: EE/KE series are appended every step
    (pypic.py:570-576) and only the plotting runs every ``nplot`` steps
    (pypic.py:579), so rate fits over scalar series stay usable on thinned
    runs while (ng,)-sized rows are bounded. Returns (final_state, metrics)
    with scalar fields (num_steps,) and heavy fields (num_steps // every,
    ...). num_steps must be a multiple of ``every``.
    """
    if num_steps % every:
        raise ValueError("num_steps must be a multiple of every")
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    cols = None
    for i in range(num_steps):
        state, metrics = step_fn(state)
        if cols is None:
            cols = [[] for _ in metrics]
        last = (i + 1) % every == 0
        for col, value in zip(cols, metrics):
            if value.dim() == 0 or last:
                col.append(value)
    return state, type(metrics)(*(torch.stack(col) for col in cols))
