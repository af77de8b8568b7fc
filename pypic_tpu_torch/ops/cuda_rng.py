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

``sheath_reinject`` replaces ``sheath_reinject_pallas``: the sheath's
thermostat and wall re-injection sweep (PIC_L_DD.py:420-450). A row takes
the words of up to three Philox blocks, counters (row, step, j, 0) for
j = 0, 1 (and 2 with a thermostat), and uses the first 5 (10) of them as
the TPU kernel lays its draws out (``reinject_bits_plain``). Its plain
versions are ``sheath_reinject_from_bits_plain`` (the transform alone; the
tests feed it the JAX kernel's threefry bits) and ``sheath_reinject_plain``
(Philox and the transform). ``sheath_uniforms`` exposes the uniforms for
the bit-equality check.

``philox_uniforms(key, step, n, ndraw, tag)`` draws the magnetized
engine's uniforms that no TPU kernel draws (the JAX engine takes them from
``jax.random``): word k of row i is word k % 4 of the Philox block at
counter (i, step, k // 4, tag). ``FLUX_TAG`` marks the wall-flux source's
eight a slot, ``GYRO_TAG`` the guiding-center gyro-phases' three; the
source batch's counter (i, step, 0, 0) has tag 0, so no two draws of a
step share a counter. A CUDA device launches the kernel (its launches
count in ``cuda_cic.LAUNCHES['philox_uniforms']``); the CPU runs
``philox_uniforms_plain``, bit-equal.

The plain transforms work on contiguous tensors, so that PyTorch's CPU
loops take one path whatever views they are handed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build, cuda_cic
from .cuda_cic import LAUNCHES, _THREADS, _blocks, _stream

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
# the fourth counter word of the draws of philox_uniforms
FLUX_TAG, GYRO_TAG = 1, 2
_MAX_DRAWS = 16


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


def _bm_radius(u: torch.Tensor) -> torch.Tensor:
    """The Box-Muller radius sqrt(-2 log u) of float32 uniforms, taken in
    float64 and rounded once to float32.

    The plain transforms compute their logarithms, sines and cosines in
    float64, so their float32 result is a function of the float32 inputs
    alone (within an ulp of the JAX kernel's float32 functions and of
    libdevice's on the card), whatever code path the CPU library takes
    for float32 in a given process."""
    return torch.sqrt(-2.0 * torch.log(u.double())).float()


def _bm_cos_sin(t: torch.Tensor):
    """(cos t, sin t) of a float32 angle, in float64 rounded once to
    float32 (see ``_bm_radius``)."""
    t = t.double()
    return torch.cos(t).float(), torch.sin(t).float()


def uniforms_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 tensor) -> float32 uniforms in [2^-23, 1): the
    low mantissa bit set, the [1, 2) exponent spliced in, minus 1
    (pallas_rng.py _u01)."""
    mant = ((bits >> 9) | 1) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def _f32(x) -> float:
    return float(np.float32(x))


def source_batch_from_bits_plain(bits, *, x_mu, x_sigma, x_wrap, vth,
                                 vx=0.0):
    """The TPU kernel's transform (pallas_rng.py:136-150) of (4, n) uint32
    words: Box-Muller on (u0, u1) and (u2, u3), x = z0 x_sigma + x_mu
    wrapped with floor(x (1/x_wrap)) x_wrap, and the same ``vx`` offset on
    all three velocity components. Returns float32 (x, vx, vy, vz)."""
    u = uniforms_from_bits(bits.to(torch.int64).contiguous())
    f32 = np.float32
    two_pi = float(f32(_TWO_PI))
    r0, r1 = _bm_radius(u[0]), _bm_radius(u[2])
    c0, s0 = _bm_cos_sin(two_pi * u[1])
    c1, s1 = _bm_cos_sin(two_pi * u[3])
    z0, z1, z2, z3 = r0 * c0, r0 * s0, r1 * c1, r1 * s1
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


# ---------------------------------------------------------------------------
# the sheath's thermostat + re-injection sweep
# ---------------------------------------------------------------------------


def reinject_ndraw(gamma: float) -> int:
    """Uniforms a row draws: 10 with a thermostat (gamma > 0), else 5
    (pallas_rng.py _ndraw)."""
    return 10 if gamma > 0.0 else 5


def reinject_bits_plain(key, step: int, n: int, ndraw: int, device="cpu"):
    """The (ndraw, n) Philox words of rows 0..n-1: word k of a row is word
    k % 4 of its block at counter (row, step, k // 4, 0)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    words = []
    for b in range(-(-ndraw // 4)):
        words += philox4x32_plain(key, (idx, int(step) & _MASK32, b, 0))
    return torch.stack(words[:ndraw])


def maxwell3_plain(u0, u1, u2, u3):
    """Three standard normals by Box-Muller from four uniforms: two from
    the first pair, one from the second pair's cosine branch
    (pallas_rng.py _maxwell3). The angles are float32 products as the
    kernel forms them; the radius and the sines and cosines come from
    float64 (``_bm_radius``)."""
    two_pi = _f32(_TWO_PI)
    r0, r1 = _bm_radius(u0), _bm_radius(u2)
    c0, s0 = _bm_cos_sin(two_pi * u1)
    c1 = _bm_cos_sin(two_pi * u3)[0]
    return r0 * c0, r0 * s0, r1 * c1


def reinject_apply(p, u, vy, vz, lost, sig, x_new, z, hit=None, sigth=None,
                   zt=None):
    """The masked update of the sweep: rows in ``lost`` take the position
    ``x_new`` and the normals ``z`` (three tensors) times ``sig``; rows in
    ``hit`` (disjoint from ``lost``) keep their position and take the
    normals ``zt`` times ``sigth``. Returns (p, u, vy, vz)."""
    p1 = torch.where(lost, x_new, p)
    u1 = torch.where(lost, z[0] * sig, u)
    vy1 = torch.where(lost, z[1] * sig, vy)
    vz1 = torch.where(lost, z[2] * sig, vz)
    if hit is not None:
        u1 = torch.where(hit, zt[0] * sigth, u1)
        vy1 = torch.where(hit, zt[1] * sigth, vy1)
        vz1 = torch.where(hit, zt[2] * sigth, vz1)
    return p1, u1, vy1, vz1


def sheath_reinject_from_bits_plain(bits, p, u, vy, vz, act, sig, sigth=None,
                                    *, cells: float, gamma: float = 0.0):
    """The TPU kernel's transform (pallas_rng.py:74-119) of (ndraw, n)
    uint32 words: rows with act != 1 re-inject at u[4] cells with the
    normals of u[0:4] times sig; with gamma > 0, rows with act == 1 and
    u[5] < gamma take the normals of u[6:10] times sigth."""
    uni = uniforms_from_bits(bits.to(torch.int64).contiguous())
    z = maxwell3_plain(*uni[0:4])
    x_new = uni[4] * _f32(cells)
    lost = act != 1.0
    if gamma > 0.0:
        hit = (act == 1.0) & (uni[5] < _f32(gamma))
        zt = maxwell3_plain(*uni[6:10])
        return reinject_apply(p, u, vy, vz, lost, sig, x_new, z, hit,
                              sig if sigth is None else sigth, zt)
    return reinject_apply(p, u, vy, vz, lost, sig, x_new, z)


def sheath_reinject_plain(key, step: int, p, u, vy, vz, act, sig, sigth=None,
                          *, cells: float, gamma: float = 0.0):
    """Philox words at counters (row, step, j, 0), then the transform:
    what the kernel computes, as tensor operations."""
    bits = reinject_bits_plain(key, step, p.shape[0], reinject_ndraw(gamma),
                               p.device)
    return sheath_reinject_from_bits_plain(bits, p, u, vy, vz, act, sig,
                                           sigth, cells=cells, gamma=gamma)


def sheath_reinject(key, step: int, p, u, vy, vz, act, sig, sigth=None, *,
                    cells: float, gamma: float = 0.0):
    """Thermostat + re-injection of the step ``step`` under the Philox
    ``key`` (two 32-bit words). ``act`` is the float status (1 active),
    ``sig`` / ``sigth`` the per-row Maxwellian sigmas sqrt(kB T / m) of the
    re-injection and of the thermostat (sigth is read only with
    gamma > 0). Returns (p, u, vy, vz), (n,) each: a CUDA device launches
    the kernel, the CPU runs ``sheath_reinject_plain``."""
    gamma = float(gamma)
    if gamma > 0.0 and sigth is None:
        sigth = sig
    arrays = (p, u, vy, vz, act, sig) + ((sigth,) if gamma > 0.0 else ())
    kind = cuda_cic._device_kind(arrays)
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in zip(("p", "u", "vy", "vz", "act", "sig", "sigth"), arrays):
        cuda_cic._check_1d(name, t, n)
    if n < 1 or n > _MASK32:
        raise ValueError(f"n must be in [1, 2^32), got {n}")
    if kind == "cpu":
        return sheath_reinject_plain(key, step, p, u, vy, vz, act, sig, sigth,
                                     cells=cells, gamma=gamma)
    dev = p.device
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    lib = _build.library()
    k0, k1 = (int(k) & _MASK32 for k in key)
    with torch.cuda.device(dev):
        err = lib.pypic_sheath_reinject(
            p.data_ptr(), u.data_ptr(), vy.data_ptr(), vz.data_ptr(),
            act.data_ptr(), sig.data_ptr(),
            (sigth if gamma > 0.0 else sig).data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(), None, n,
            k0, k1, int(step) & _MASK32, _f32(cells), _f32(gamma),
            _f32(_TWO_PI), int(gamma > 0.0), _blocks(n, dev), _THREADS,
            _stream(dev))
    _build.check(err, "sheath_reinject")
    LAUNCHES["sheath_reinject"] += 1
    return out[0], out[1], out[2], out[3]


def sheath_uniforms(key, step: int, n: int, *, gamma: float, device):
    """The (ndraw, n) float32 uniforms the sweep transforms: from the
    kernel on a CUDA device (its uniforms variant), from
    ``reinject_bits_plain`` on the CPU. For the bit-equality check; the
    engine never calls it."""
    dev = _kind(device)
    ndraw = reinject_ndraw(float(gamma))
    if dev.type == "cpu":
        return uniforms_from_bits(reinject_bits_plain(key, step, n, ndraw, dev))
    out = torch.empty((ndraw, n), dtype=torch.float32, device=dev)
    lib = _build.library()
    k0, k1 = (int(k) & _MASK32 for k in key)
    with torch.cuda.device(dev):
        err = lib.pypic_sheath_reinject(
            *([None] * 11), out.data_ptr(), n, k0, k1, int(step) & _MASK32,
            0.0, _f32(gamma), _f32(_TWO_PI), int(ndraw == 10),
            _blocks(n, dev), _THREADS, _stream(dev))
    _build.check(err, "sheath_uniforms")
    LAUNCHES["sheath_uniforms"] += 1
    return out


# ---------------------------------------------------------------------------
# tagged uniforms: the flux source and the gyro-phases
# ---------------------------------------------------------------------------


def philox_uniforms_plain(key, step: int, n: int, ndraw: int, tag: int,
                          device="cpu") -> torch.Tensor:
    """The (ndraw, n) float32 uniforms of ``philox_uniforms`` as tensor
    operations."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    words = []
    for b in range(-(-ndraw // 4)):
        words += philox4x32_plain(key, (idx, int(step) & _MASK32, b,
                                        int(tag) & _MASK32))
    return uniforms_from_bits(torch.stack(words[:ndraw]))


def philox_uniforms(key, step: int, n: int, ndraw: int, tag: int, *,
                    device) -> torch.Tensor:
    """(ndraw, n) float32 uniforms in [2^-23, 1) for ``step`` under the
    Philox ``key`` (two 32-bit words), drawn at counters (row, step, block,
    tag). A CUDA device launches the kernel; the CPU runs the plain
    version."""
    dev = _kind(device)
    if n < 1 or n > _MASK32:
        raise ValueError(f"n must be in [1, 2^32), got {n}")
    if not 1 <= ndraw <= _MAX_DRAWS:
        raise ValueError(f"ndraw must be in [1, {_MAX_DRAWS}], got {ndraw}")
    if dev.type == "cpu":
        return philox_uniforms_plain(key, step, n, ndraw, tag, dev)
    lib = _build.library()
    out = torch.empty((ndraw, n), dtype=torch.float32, device=dev)
    k0, k1 = (int(k) & _MASK32 for k in key)
    with torch.cuda.device(dev):
        err = lib.pypic_philox_uniforms(
            out.data_ptr(), n, int(ndraw), k0, k1, int(step) & _MASK32,
            int(tag) & _MASK32, _blocks(n, dev), _THREADS, _stream(dev))
    _build.check(err, "philox_uniforms")
    LAUNCHES["philox_uniforms"] += 1
    return out
