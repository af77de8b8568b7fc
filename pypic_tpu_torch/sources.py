"""Particle sources (the counterpart of ``pypic_tpu/sources.py``).

``sample_source_batch`` is the magnetized engine's re-activation sampler:
the volumetric Maxwellian source of pygcpic.py:723-755 (x ~ N(L/2, L/12)
wrapped into [0, L), each velocity component ~ N(vx, vth), vth =
sqrt(kB Ti / m)), drawn for a full-capacity batch through the
``ops.cuda_rng.source_batch`` kernel: the port's form of the JAX
engine's 'pallas' sampler.

The JAX package's other samplers are not here. 'threefry' draws from
``jax.random``, whose streams PyTorch cannot reproduce, and 'hash' exists
for data-parallel runs (ROADMAP queue 1, item 17); the flux source comes
with the magnetized stack's next slice. Tests that compare the engine with
the JAX package replay the JAX draws instead (``engines.magnetized.
make_step(source_draws=...)``).
"""

from __future__ import annotations

import numpy as np

from .constants import K_BOLTZMANN
from .grid import GridSpec
from .ops import cuda_rng


def sample_source_batch(key, step: int, n: int, grid: GridSpec, ti: float,
                        mass: float, vx: float = 0.0, *, device):
    """``n`` source draws for ``step`` under the Philox ``key`` (two 32-bit
    words) on ``device``: {"x" [m], "vx", "vy", "vz" [m/s]}, (n,) float32
    each (pallas_rng.source_batch_pallas's x_mu = L/2, x_sigma = L/12,
    x_wrap = L; magnetized.py:1184-1194)."""
    vth = float(np.sqrt(K_BOLTZMANN * float(ti) / float(mass)))
    length = grid.length
    x, bvx, bvy, bvz = cuda_rng.source_batch(
        key, step, n, x_mu=length / 2.0, x_sigma=length / 12.0,
        x_wrap=length, vth=vth, vx=vx, device=device)
    return {"x": x, "vx": bvx, "vy": bvy, "vz": bvz}
