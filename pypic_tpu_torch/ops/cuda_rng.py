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
device and runs ``source_batch_plain`` for the CPU, either way into views
of one row-padded buffer (``cuda_cic.padded_rows``); it counts its
launches in ``cuda_cic.LAUNCHES['source_batch']``. The normals of the kernel and of
the plain version differ by a float32 ulp or two (libdevice's logf and
sqrtf and the kernel's sine-cosine polynomials against the CPU's float64
functions); the uniforms are bit-equal, which ``source_uniforms`` exposes
for the check.

``sheath_reinject`` replaces ``sheath_reinject_pallas``: the sheath's
thermostat and wall re-injection sweep (PIC_L_DD.py:420-450). A row takes
the words of up to three Philox blocks, counters (row, step, j, 0) for
j = 0, 1 (and 2 with a thermostat), and uses the first 5 (10) of them as
the TPU kernel lays its draws out (``reinject_bits_plain``). Its plain
versions are ``sheath_reinject_from_bits_plain`` (the transform alone; the
tests feed it the JAX kernel's threefry bits) and ``sheath_reinject_plain``
(Philox and the transform). ``sheath_uniforms`` exposes the uniforms for
the bit-equality check. Float64 rows (a float64 state) take the double
kernel: the draws stay the float kernel's float32 (as the TPU kernel
draws in float32), their products with the float64 sigmas and the
stores are float64, as the plain version computes on float64 tensors.

``philox_uniforms(key, step, n, ndraw, tag)`` draws the magnetized
engine's uniforms that no TPU kernel draws (the JAX engine takes them from
``jax.random``): word k of row i is word k % 4 of the Philox block at
counter (i, step, k // 4, tag). ``FLUX_TAG`` marks the wall-flux source's
eight a slot, ``GYRO_TAG`` the guiding-center gyro-phases' three,
``ION_TAG`` the ionization attempt's one; the source batch's counter
(i, step, 0, 0) has tag 0, so no two draws of a step share a counter. A CUDA device launches the kernel (its launches
count in ``cuda_cic.LAUNCHES['philox_uniforms']``); the CPU runs
``philox_uniforms_plain``, bit-equal.

``hash_batch(seed, n, streams, offset=..., normals=..., device=...)``
draws the counter-based 'hash' sampler of the JAX package
(``pypic_tpu/sources.py`` ``hash_uniforms``, ``hash_normals``), which no
TPU kernel draws: stream s of slot i hashes the slot id i + offset with
murmur3's 32-bit finalizer (``mix32_plain``) under a uint32 ``seed``, so a
rank that passes offset = rank x n draws what one device draws for its
slots. The uniforms are bit-equal to JAX's; ``normals`` gives the
Box-Muller pairs in JAX's layout. ``dtype=torch.float64`` draws as JAX
does for a float64 state: the uniforms ((h >> 8) + 1/2) 2^-24 exact in
float64, the normals by float64 log, sqrt, cos and sin (the kernel's
libdevice functions within 4 float64 ulps of the CPU's). A CUDA device
launches the kernel
(``csrc/rng.cu`` hash_batch_kernel; ``LAUNCHES['hash_batch']``), the CPU
runs ``hash_batch_plain``: int64 tensor arithmetic masked to 32 bits, each
32 x 32-bit product from 16-bit halves (this PyTorch has no uint32
shifts, xors or adds).

The plain transforms work on contiguous tensors, so that PyTorch's CPU
loops take one path whatever views they are handed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, cuda_cic
from .cuda_cic import LAUNCHES, _THREADS, _blocks, _stream

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
# the fourth counter word of the draws of philox_uniforms
FLUX_TAG, GYRO_TAG, ION_TAG = 1, 2, 3
_MAX_DRAWS = 16
# threads a block of the source kernel (tools/resident_split.py --kernel
# source_batch: 512 read 1.7% under 256 and 1.3% under 128, PERF.md §6)
SOURCE_THREADS = 512
# rows a thread takes in one pass of the source kernel's main loop
# (csrc/rng.cu source_batch_kernel: rows i, i + S, i + 2S, i + 3S)
SOURCE_ROWS_A_PASS = 4


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


@functools.lru_cache(maxsize=None)
def _source_blocks_per_sm(index: int, uniforms: bool) -> int:
    """SOURCE_THREADS-thread blocks of the source kernel one SM of device
    ``index`` holds at once at the kernel's registers (asked once)."""
    with torch.cuda.device(index):
        per_sm = _build.library().pypic_source_blocks_per_sm(SOURCE_THREADS,
                                                             int(uniforms))
    if per_sm < 0:
        _build.check(-per_sm, "source_batch occupancy")
    return max(per_sm, 1)


def source_grid(n: int, index: int, uniforms: bool = False) -> int:
    """Blocks of the source kernel's launch: one wave, as many as the card
    holds at once, no more than the rows fill."""
    per_sm = _source_blocks_per_sm(index, uniforms)
    return max(1, min(per_sm * cuda_cic._sm_count(index), -(-n // SOURCE_THREADS)))


def _launch(outs, key, step, n, uniforms: bool, dev, x_mu=0.0, x_sigma=0.0,
            x_wrap=1.0, vth=0.0, vx=0.0):
    """The source kernel into the four (n,) float32 tensors ``outs``: the
    batch, or with ``uniforms`` its four uniforms (u0..u3), on
    ``source_grid`` blocks of SOURCE_THREADS threads."""
    lib = _build.library()
    f32 = np.float32
    k0, k1 = (int(k) & _MASK32 for k in key)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    blocks = source_grid(n, index, uniforms)
    with torch.cuda.device(dev):
        err = lib.pypic_source_batch(
            *(o.data_ptr() for o in outs), n, k0, k1, int(step) & _MASK32,
            float(f32(x_mu)), float(f32(x_sigma)), float(f32(x_wrap)),
            float(f32(1.0 / x_wrap)), float(f32(vth)), float(f32(vx)),
            float(f32(_TWO_PI)), int(uniforms), blocks, SOURCE_THREADS,
            _stream(dev))
    _build.check(err, "source_batch")


def _kind(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def source_batch(key, step: int, n: int, *, x_mu, x_sigma, x_wrap, vth,
                 vx=0.0, device):
    """The source batch of ``n`` draws for ``step`` under the Philox
    ``key`` (two 32-bit words), on ``device``: (x, vx, vy, vz), (n,)
    float32 each, x in the units of x_mu / x_sigma / x_wrap, as views of
    one buffer whose rows are padded to 4 floats (``cuda_cic.padded_rows``:
    each contiguous and 16-B aligned, so that the step's next kernels read
    them with aligned vector loads whatever n is). A CUDA device launches
    the kernel; the CPU runs ``source_batch_plain``."""
    dev = _kind(device)
    if n < 1 or n > _MASK32:
        raise ValueError(f"n must be in [1, 2^32), got {n}")
    kw = dict(x_mu=x_mu, x_sigma=x_sigma, x_wrap=x_wrap, vth=vth, vx=vx)
    outs = cuda_cic.padded_rows(4, n, dev)
    if dev.type == "cpu":
        for o, r in zip(outs, source_batch_plain(key, step, n, device=dev, **kw)):
            o.copy_(r)
        return outs
    _launch(outs, key, step, n, False, dev, **kw)
    LAUNCHES["source_batch"] += 1
    return outs


def source_uniforms(key, step: int, n: int, *, device) -> torch.Tensor:
    """The (4, n) float32 uniforms the source batch transforms: from the
    kernel on a CUDA device (its uniforms variant), from
    ``philox4x32_plain`` on the CPU. For the bit-equality check; the
    engine never calls it."""
    dev = _kind(device)
    if dev.type == "cpu":
        words = philox4x32_plain(key, _counters(step, n, dev))
        return uniforms_from_bits(torch.stack(words))
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    _launch(tuple(out), key, step, n, True, dev)
    LAUNCHES["source_uniforms"] += 1
    return out


# ---------------------------------------------------------------------------
# the sheath's thermostat + re-injection sweep
# ---------------------------------------------------------------------------


def reinject_ndraw(gamma: float) -> int:
    """Uniforms a row draws: 10 with a thermostat (gamma > 0), else 5
    (pallas_rng.py _ndraw)."""
    return 10 if gamma > 0.0 else 5


def reinject_bits_plain(key, step: int, n: int, ndraw: int, device="cpu",
                        tag: int = 0):
    """The (ndraw, n) Philox words of rows 0..n-1: word k of a row is word
    k % 4 of its block at counter (row, step, k // 4, tag)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    words = []
    for b in range(-(-ndraw // 4)):
        words += philox4x32_plain(key, (idx, int(step) & _MASK32, b,
                                        int(tag) & _MASK32))
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
                          *, cells: float, gamma: float = 0.0, tag: int = 0):
    """Philox words at counters (row, step, j, tag), then the transform:
    what the kernel computes, as tensor operations."""
    bits = reinject_bits_plain(key, step, p.shape[0], reinject_ndraw(gamma),
                               p.device, tag)
    return sheath_reinject_from_bits_plain(bits, p, u, vy, vz, act, sig,
                                           sigth, cells=cells, gamma=gamma)


def sheath_reinject(key, step: int, p, u, vy, vz, act, sig, sigth=None, *,
                    cells: float, gamma: float = 0.0, tag: int = 0):
    """Thermostat + re-injection of the step ``step`` under the Philox
    ``key`` (two 32-bit words), at counters (row, step, j, tag): ``tag``
    0 is the single-device engine's stream, the slab engine passes its
    rank's. ``act`` is the float status (1 active),
    ``sig`` / ``sigth`` the per-row Maxwellian sigmas sqrt(kB T / m) of the
    re-injection and of the thermostat (sigth is read only with
    gamma > 0). All of one dtype, float32 or float64 (a float64 state: the
    draws stay float32, as the TPU kernel's, and only their products with
    the sigmas and the stores are float64). Returns (p, u, vy, vz), (n,)
    each in that dtype, as views of one buffer whose rows are padded to 4
    elements (``cuda_cic.padded_rows``): a CUDA device launches the
    kernel (the double one for float64, counted as
    ``sheath_reinject_f64``), the CPU runs ``sheath_reinject_plain``."""
    gamma = float(gamma)
    if gamma > 0.0 and sigth is None:
        sigth = sig
    arrays = (p, u, vy, vz, act, sig) + ((sigth,) if gamma > 0.0 else ())
    kind = cuda_cic._device_kind(arrays, "sheath_reinject")
    n = p.shape[0] if p.dim() == 1 else -1
    for name, t in zip(("p", "u", "vy", "vz", "act", "sig", "sigth"), arrays):
        cuda_cic._check_1d(name, t, n)
    if n < 1 or n > _MASK32:
        raise ValueError(f"n must be in [1, 2^32), got {n}")
    outs = cuda_cic.padded_rows(4, n, p.device, p.dtype)
    if kind == "cpu":
        ref = sheath_reinject_plain(key, step, p, u, vy, vz, act, sig, sigth,
                                    cells=cells, gamma=gamma, tag=tag)
        for o, r in zip(outs, ref):
            o.copy_(r)
        return outs
    dev = p.device
    fn, name = cuda_cic._launcher(_build.library(), "sheath_reinject", p.dtype)
    k0, k1 = (int(k) & _MASK32 for k in key)
    with torch.cuda.device(dev):
        err = fn(
            p.data_ptr(), u.data_ptr(), vy.data_ptr(), vz.data_ptr(),
            act.data_ptr(), sig.data_ptr(),
            (sigth if gamma > 0.0 else sig).data_ptr(),
            *(o.data_ptr() for o in outs), None, n, k0, k1,
            int(step) & _MASK32, int(tag) & _MASK32, _f32(cells), _f32(gamma),
            _f32(_TWO_PI),
            int(gamma > 0.0), _blocks(n, dev), _THREADS, _stream(dev))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return outs


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
            0, 0.0, _f32(gamma), _f32(_TWO_PI), int(ndraw == 10),
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


# ---------------------------------------------------------------------------
# the counter-based 'hash' sampler (sources.hash_uniforms in JAX)
# ---------------------------------------------------------------------------

_GOLDEN = 0x9E3779B9  # 2^32 / phi: the streams' counter offsets
_HASH_MAX_STREAMS = 16


def _mul32(a: int, x: torch.Tensor) -> torch.Tensor:
    """(a x) mod 2^32 of the constant a and the uint32 words x (int64)."""
    return (x * (a & 0xFFFF) + (((x * (a >> 16)) & 0xFFFF) << 16)) & _MASK32


def mix32_plain(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 words held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(0x85EBCA6B, x)
    x = x ^ (x >> 13)
    x = _mul32(0xC2B2AE35, x)
    return x ^ (x >> 16)


def _check_hash_dtype(dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"hash_batch: dtype must be float32 or float64, got {dtype}")


def hash_uniforms_plain(seed: int, n: int, streams: int, offset: int = 0,
                        device="cpu", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(streams, n) uniforms in (0, 1] of the hash sampler:
    h = mix(mix(i + offset + (s + 1) golden) ^ seed), u = ((h >> 8) +
    1/2) 2^-24, each integer sum taken mod 2^32 (JAX's uint32 wrap), the
    sum taken in ``dtype`` as JAX takes it: in float32 rounded to even (to
    1 at the top), in float64 exact."""
    _check_hash_dtype(dtype)
    idx = (torch.arange(n, dtype=torch.int64, device=device)
           + (int(offset) & _MASK32)) & _MASK32
    offs = torch.tensor([((s + 1) * _GOLDEN) & _MASK32 for s in range(streams)],
                        dtype=torch.int64, device=device)[:, None]
    h = mix32_plain(mix32_plain((idx[None, :] + offs) & _MASK32)
                    ^ (int(seed) & _MASK32))
    return ((h >> 8).to(dtype) + 0.5) * 2.0 ** -24


def hash_normals_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """(2 pairs, n) Box-Muller normals of (2 pairs, n) uniforms, JAX's
    layout (sources.hash_normals): rows r cos t, then rows r sin t, with
    r = sqrt(-2 log u[2p]) and t = (2 pi) u[2p + 1]. Float32 uniforms:
    float32 angles, the functions in float64 rounded once (``_bm_radius``);
    float64 uniforms: everything in float64, as JAX under x64
    (pypic_tpu/sources.py:93-99)."""
    if u.dtype == torch.float64:
        r = torch.sqrt(-2.0 * torch.log(u[0::2].contiguous()))
        t = _TWO_PI * u[1::2].contiguous()
        return torch.cat([r * torch.cos(t), r * torch.sin(t)], dim=0)
    r = _bm_radius(u[0::2].contiguous())
    cos, sin = _bm_cos_sin(_f32(_TWO_PI) * u[1::2].contiguous())
    return torch.cat([r * cos, r * sin], dim=0)


def hash_batch_plain(seed: int, n: int, streams: int, offset: int = 0,
                     normals: bool = False, device="cpu",
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """What ``hash_batch`` computes, as tensor operations."""
    u = hash_uniforms_plain(seed, n, streams, offset, device, dtype)
    return hash_normals_from_uniforms(u) if normals else u


def hash_batch(seed: int, n: int, streams: int, *, offset: int = 0,
               normals: bool = False, device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (streams, n) draws of the hash sampler, in ``dtype`` (float32,
    or float64 for a float64 state, as JAX draws in the state's dtype),
    for slots offset .. offset + n - 1 under the uint32 ``seed``: the
    uniforms, or with ``normals`` the Box-Muller normals of the stream
    pairs (streams even). A CUDA device launches the kernel (its double
    form for float64, counted as ``hash_batch_f64``); the CPU runs the
    plain version."""
    dev = _kind(device)
    _check_hash_dtype(dtype)
    if n < 1 or n > _MASK32:
        raise ValueError(f"n must be in [1, 2^32), got {n}")
    if not 1 <= streams <= _HASH_MAX_STREAMS or (normals and streams % 2):
        raise ValueError(f"streams must be in [1, {_HASH_MAX_STREAMS}] (even "
                         f"for normals), got {streams}")
    if dev.type == "cpu":
        return hash_batch_plain(seed, n, streams, offset, normals, dev, dtype)
    fn, name = cuda_cic._launcher(_build.library(), "hash_batch", dtype)
    out = torch.empty((streams, n), dtype=dtype, device=dev)
    two_pi = _TWO_PI if dtype == torch.float64 else _f32(_TWO_PI)
    with torch.cuda.device(dev):
        err = fn(
            out.data_ptr(), n, int(streams), int(offset) & _MASK32,
            int(seed) & _MASK32, two_pi, int(bool(normals)),
            _blocks(n, dev), _THREADS, _stream(dev))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out
