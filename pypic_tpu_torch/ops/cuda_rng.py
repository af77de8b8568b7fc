"""Per-particle random draws in a kernel (the counterpart of
``pypic_tpu/ops/pallas_rng.py``).

``source_batch`` replaces ``source_batch_pallas``: a full-capacity
volumetric source batch, x ~ N(x_mu, x_sigma) wrapped into [0, x_wrap)
and vx, vy, vz ~ N(vx, vth) (pygcpic.py:723-755), with no per-particle
input. The TPU kernel draws from the TPU core's hardware generator; the
kernel here (``csrc/rng.cu``) draws one Philox4x32-10 block a particle,
keyed by two 32-bit key words, at counter (particle index, step, 0, 0),
and applies the TPU kernel's transform to its four words.

Plain versions:

* ``philox4x32_plain(key, counter)``: Philox4x32-10 in int64 tensor
  arithmetic, each 32 x 32-bit product split into 16-bit halves; its bits
  equal the kernel's.
* ``source_batch_from_bits_plain(bits, ...)``: the transform alone, from
  (4, n) uint32 words (the tests feed it the JAX kernel's threefry bits).
* ``source_batch_plain``: the two together, what a CPU device runs.

``source_batch(key, step, n, device=...)`` launches the kernel for a CUDA
device and runs ``source_batch_plain`` for the CPU; it counts its launches
in ``cuda_cic.LAUNCHES['source_batch']``. The normals of the kernel and of
the plain version differ by a few float32 ulps (libdevice's logf, sinf and
cosf against the CPU's); the uniforms are bit-equal, which
``source_uniforms`` exposes for the check.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .cuda_cic import LAUNCHES, _THREADS, _blocks, _stream

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant a and
    the uint32 words b (int64 tensor), from 16-bit halves so that no
    partial product overflows int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    cross = a_hi * b_lo + a_lo * b_hi  # < 2^33
    low = a_lo * b_lo + ((cross & 0xFFFF) << 16)  # < 2^33
    lo = low & _MASK32
    hi = a_hi * b_hi + (cross >> 16) + (low >> 32)
    return hi & _MASK32, lo


def philox4x32_plain(key, counter):
    """Philox4x32-10 (Random123's constants): ``key`` two ints, ``counter``
    four int64 tensors (or ints) broadcast together, each holding uint32
    values. Returns the four output words as int64 tensors."""
    k0, k1 = (int(k) & _MASK32 for k in key)
    dev = next((x.device for x in counter if isinstance(x, torch.Tensor)), None)
    c = [torch.as_tensor(x, dtype=torch.int64, device=dev) for x in counter]
    c = list(torch.broadcast_tensors(*c))
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + _W0) & _MASK32
        k1 = (k1 + _W1) & _MASK32
    return c


def uniforms_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 tensor) -> float32 uniforms in [2^-23, 1): the
    low mantissa bit set, the [1, 2) exponent spliced in, minus 1
    (pallas_rng.py _u01)."""
    mant = ((bits >> 9) | 1) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def source_batch_from_bits_plain(bits, *, x_mu, x_sigma, x_wrap, vth,
                                 vx=0.0):
    """The TPU kernel's transform (pallas_rng.py:136-150) of (4, n) uint32
    words: Box-Muller on (u0, u1) and (u2, u3), x = z0 x_sigma + x_mu
    wrapped with floor(x (1/x_wrap)) x_wrap, and the same ``vx`` offset on
    all three velocity components. Returns float32 (x, vx, vy, vz)."""
    u = uniforms_from_bits(bits.to(torch.int64))
    f32 = np.float32
    two_pi = float(f32(_TWO_PI))
    r0 = torch.sqrt(-2.0 * torch.log(u[0]))
    t0 = two_pi * u[1]
    r1 = torch.sqrt(-2.0 * torch.log(u[2]))
    t1 = two_pi * u[3]
    z0 = r0 * torch.cos(t0)
    z1 = r0 * torch.sin(t0)
    z2 = r1 * torch.cos(t1)
    z3 = r1 * torch.sin(t1)
    x = z0 * float(f32(x_sigma)) + float(f32(x_mu))
    x = x - torch.floor(x * float(f32(1.0 / x_wrap))) * float(f32(x_wrap))
    vth, vx = float(f32(vth)), float(f32(vx))
    return x, z1 * vth + vx, z2 * vth + vx, z3 * vth + vx


def _counters(step: int, n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (idx, int(step) & _MASK32, 0, 0)


def source_batch_plain(key, step: int, n: int, *, x_mu, x_sigma, x_wrap, vth,
                       vx=0.0, device="cpu"):
    """Philox words at counters (i, step, 0, 0), i < n, then the
    transform: what the kernel computes, as tensor operations."""
    words = philox4x32_plain(key, _counters(step, n, device))
    return source_batch_from_bits_plain(torch.stack(words), x_mu=x_mu,
                                        x_sigma=x_sigma, x_wrap=x_wrap,
                                        vth=vth, vx=vx)


def _launch(key, step, n, uniforms: bool, dev, x_mu=0.0, x_sigma=0.0,
            x_wrap=1.0, vth=0.0, vx=0.0):
    lib = _build.library()
    f32 = np.float32
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    k0, k1 = (int(k) & _MASK32 for k in key)
    with torch.cuda.device(dev):
        err = lib.pypic_source_batch(
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), n, k0, k1, int(step) & _MASK32,
            float(f32(x_mu)), float(f32(x_sigma)), float(f32(x_wrap)),
            float(f32(1.0 / x_wrap)), float(f32(vth)), float(f32(vx)),
            float(f32(_TWO_PI)), int(uniforms), _blocks(n, dev), _THREADS,
            _stream(dev))
    _build.check(err, "source_batch")
    return out


def _kind(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def source_batch(key, step: int, n: int, *, x_mu, x_sigma, x_wrap, vth,
                 vx=0.0, device):
    """The source batch of ``n`` draws for ``step`` under the Philox
    ``key`` (two 32-bit words), on ``device``: (x, vx, vy, vz), (n,)
    float32 each, x in the units of x_mu / x_sigma / x_wrap. A CUDA device
    launches the kernel; the CPU runs ``source_batch_plain``."""
    dev = _kind(device)
    if n < 1 or n > _MASK32:
        raise ValueError(f"n must be in [1, 2^32), got {n}")
    kw = dict(x_mu=x_mu, x_sigma=x_sigma, x_wrap=x_wrap, vth=vth, vx=vx)
    if dev.type == "cpu":
        return source_batch_plain(key, step, n, device=dev, **kw)
    out = _launch(key, step, n, False, dev, **kw)
    LAUNCHES["source_batch"] += 1
    return out[0], out[1], out[2], out[3]


def source_uniforms(key, step: int, n: int, *, device) -> torch.Tensor:
    """The (4, n) float32 uniforms the source batch transforms: from the
    kernel on a CUDA device (its uniforms variant), from
    ``philox4x32_plain`` on the CPU. For the bit-equality check; the
    engine never calls it."""
    dev = _kind(device)
    if dev.type == "cpu":
        words = philox4x32_plain(key, _counters(step, n, dev))
        return uniforms_from_bits(torch.stack(words))
    out = _launch(key, step, n, True, dev)
    LAUNCHES["source_uniforms"] += 1
    return out
