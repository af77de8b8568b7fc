"""Particle sources (the counterpart of ``pypic_tpu/sources.py``).

The magnetized engine's two re-activation samplers, each a full-capacity
batch drawn on the state's device:

* ``sample_source_batch``: the volumetric Maxwellian source of
  pygcpic.py:723-755 (x ~ N(L/2, L/12) wrapped into [0, L), each velocity
  component ~ N(vx, vth), vth = sqrt(kB Ti / m)), through the
  ``ops.cuda_rng.source_batch`` kernel: the port's form of the JAX
  engine's 'pallas' sampler.
* ``sample_flux_batch``: the wall-flux source of pygcpic.py:760-778 (x in
  the last cell, v_x from the flux-weighted speed distribution
  |v| g(v; vx, vth) on a 100-point table with half a bin of jitter, made
  incoming, plus a probability-gamma beam at ``vx_pert * vth``): the
  transform of the JAX package's ``sample_flux_6d_hash`` on eight Philox
  uniforms a slot (``ops.cuda_rng.philox_uniforms``, ``FLUX_TAG``). The
  JAX engine has no Pallas kernel for this draw ('auto' falls back to
  threefry for flux there); the transform is tensor operations on the
  card, and its table lives on the device.

'auto' resolves to these two. The JAX package's 'threefry' sampler draws
from ``jax.random``, whose streams PyTorch cannot reproduce, and its
'hash' sampler exists for data-parallel runs (ROADMAP queue 1, item 17):
both raise in the engine. Tests that compare the engine with the JAX
package replay the JAX draws instead (``engines.magnetized.
make_step(source_draws=...)``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .constants import K_BOLTZMANN
from .grid import GridSpec
from .ops import cuda_rng

NUM_VELS = 100  # the flux table's points (pygcpic.py:760-778)


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


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num, dtype=float32)`` as JAX's CPU
    backend evaluates it on the host: XLA rewrites start (1 - i / d) +
    stop i / d (d = num - 1) into fma(i, stop c, start (1 - i c)) with
    c = f32(1 / d); the fused multiply-add is taken in float64 (the
    product of two float32 values is exact there) and rounded once. The
    endpoint is appended."""
    f32, f64 = np.float32, np.float64
    lo, hi = f32(start), f32(stop)
    i = np.arange(num - 1, dtype=f32)
    c = f32(1.0 / (num - 1))
    head = lo * (f32(1.0) - i * c)
    out = (i.astype(f64) * f64(hi * c) + head.astype(f64)).astype(f32)
    return np.concatenate([out, [hi]]).astype(f32)


class FluxTable(NamedTuple):
    vels: np.ndarray  # (NUM_VELS,) float32 speeds on [-6 vth, 6 vth]
    cdf: np.ndarray  # (NUM_VELS,) float32 CDF of |v| g(v; vx, vth)
    dvel: float  # the table's spacing, a float32 value


def flux_table(ti: float, mass: float, vx: float = 0.0) -> FluxTable:
    """The flux source's speed table and CDF as host constants, in the
    float32 operations of ``sample_flux_6d_hash`` (the CDF's sums in
    float64, rounded once: JAX sums it in its own order)."""
    f32 = np.float32
    vth = float(np.sqrt(K_BOLTZMANN * float(ti) / float(mass)))
    vels = linspace_f32(-6.0 * vth, 6.0 * vth, NUM_VELS)
    weights = (np.exp(-((vels - f32(vx)) ** 2) / f32(2.0 * vth * vth))
               * np.abs(vels)).astype(f32)
    w64 = weights.astype(np.float64)
    cdf = (np.cumsum(w64) / w64.sum()).astype(f32)
    return FluxTable(vels, cdf, float(vels[1] - vels[0]))


@functools.lru_cache(maxsize=None)
def _device_table(ti: float, mass: float, vx: float, device: torch.device):
    """(vels, cdf) of ``flux_table`` on ``device``, copied there once."""
    t = flux_table(ti, mass, vx)
    return (torch.from_numpy(t.vels).to(device),
            torch.from_numpy(t.cdf).to(device), t.dvel)


def flux_from_uniforms(u: torch.Tensor, grid: GridSpec, ti: float,
                       mass: float, vx: float = 0.0, gamma: float = 0.0,
                       vx_pert: float = 0.0):
    """The transform of ``sample_flux_6d_hash`` (components form) of the
    (8, n) float32 uniforms ``u``: x = L - dx u0; vy, vz from Box-Muller
    on (u1, u3) and (u2, u4); the table index by the CDF's left-side
    search of u5, clamped to the table; v_x = -|vels[idx]| + jitter + vx
    with jitter (2 u6 - 1) dvel / 2, then vx_pert vth where u7 < gamma.
    Returns {"x" [m], "vx", "vy", "vz"}."""
    f32 = np.float32
    dev = u.device
    vth = float(np.sqrt(K_BOLTZMANN * float(ti) / float(mass)))
    vels, cdf, dvel = _device_table(float(ti), float(mass), float(vx), dev)
    two_pi = float(f32(2.0 * np.pi))
    x = float(f32(grid.length)) - float(f32(grid.dx)) * u[0]
    r1 = torch.sqrt(-2.0 * torch.log(u[1]))
    r2 = torch.sqrt(-2.0 * torch.log(u[2]))
    zy = r1 * torch.sin(two_pi * u[3]) * float(f32(vth))
    zz = r2 * torch.cos(two_pi * u[4]) * float(f32(vth))
    idx = torch.clamp(torch.searchsorted(cdf, u[5]),
                      max=NUM_VELS - 1)
    jitter = (2.0 * u[6] - 1.0) * float(f32(dvel) / f32(2.0))
    v_x = (-torch.abs(vels[idx]) + jitter) + float(f32(vx))
    v_x = torch.where(u[7] < float(f32(gamma)), float(f32(vx_pert * vth)), v_x)
    return {"x": x, "vx": v_x, "vy": zy, "vz": zz}


def sample_flux_batch(key, step: int, n: int, grid: GridSpec, ti: float,
                      mass: float, vx: float = 0.0, gamma: float = 0.0,
                      vx_pert: float = 0.0, *, device):
    """``n`` wall-flux draws for ``step`` under the Philox ``key`` on
    ``device``: {"x" [m], "vx", "vy", "vz" [m/s]}, (n,) float32 each (the
    distribution of ``sample_flux_6d``, pygcpic.py:760-778; the engine
    makes v_x incoming after the draw)."""
    u = cuda_rng.philox_uniforms(key, step, n, 8, cuda_rng.FLUX_TAG,
                                 device=device)
    return flux_from_uniforms(u, grid, ti, mass, vx, gamma, vx_pert)
