"""One implicit and one explicit step above the kernels' shared-memory
ceilings (ng = 32,768), the port's plain kernel versions against the JAX
package's Pallas kernels in interpret mode, from one shared state.

At such a grid a float32 step is ill-conditioned in its positions: a
position p ~ ng carries an ulp of ng 2^-24 cells (2^-8 at 32,768), the
deposits are sparse (a few particles a cell), so a rounding of p moves the
CIC weights, the current and through it the field and the push. Both
packages' float32 steps sit as far from a float64 step of the same state
as that float64 step moves when its input positions move by half a
float32 ulp (delta_s below): round-off, which the ng = 64 tests' limits do
not cover. Each float32 step is held within 3 delta_s of the float64 step
(a step rounds each position at least three times: the push's two sums,
the midpoint and the wrap; independent half-ulp roundings add in
quadrature) and the two packages within 6 delta_s of each other. The
float64 step is the port's own plain versions on float64 tensors.
"""

import numpy as np
import pytest
import torch

from pypic_tpu.constants import E_CHARGE, M_ELECTRON
from pypic_tpu.engines import explicit as jexplicit
from pypic_tpu.engines import implicit as jimplicit

from pypic_tpu_torch import interop
from pypic_tpu_torch.engines import explicit, implicit
from pypic_tpu_torch.ops import cuda_cic

from test_torch_explicit import _configs as _explicit_configs
from test_torch_explicit import _two_stream_load
from test_torch_implicit import _configs as _implicit_configs
from test_torch_implicit import _landau_load

NG = 32_768  # above every two-array ceiling (29,056): the global mode on the card
ROUNDINGS = 3.0  # delta_s a float32 step may sit from the float64 step


def _gap(a, b, key, ng):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if key == "p":  # cells, a pair across the seam counted the short way
        d = np.abs(a - b)
        return float(np.minimum(d, ng - d).max())
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.fixture
def float64_plain():
    """The plain versions take float64 CPU tensors (the reference step):
    the wrappers' dtype check admits float64 on the CPU, as the engines'
    float64 states need."""
    for name in cuda_cic.F64_KERNELS:
        cuda_cic.check_dtype(name, torch.device("cpu"), torch.float64)


def test_implicit_step_at_32768_is_round_off_from_float64(float64_plain):
    """One conserving implicit step at ng = 32,768 (n = 65,536: 2
    particles a cell) from one JAX state: JAX's fused Pallas step, the
    port's plain step, the float64 step and the float64 step from
    positions moved half an ulp. The port is no farther from float64
    than JAX (measured: p 1.03e-2 cells both, e 6.65e-4 both, against
    delta_s p 9.3e-3, e 7.0e-4; the float64 step's scalars in float64
    since the engines take a float64 state, 1.28e-2 and 7.8e-4 when
    they were float32)."""
    ng, length, x, v, params = _landau_load(n=65_536, ng=NG, seed=3)
    jcfg, tcfg = _implicit_configs(ng, length, params)
    jst = jimplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    d = {k: np.asarray(getattr(jst, k)) for k in interop._FIELDS}
    jst1, jm = jimplicit.make_step(jcfg)(jst)
    step = implicit.make_step(tcfg)
    tst1, tm = step(interop.implicit_state_from_numpy(d, "cpu"))
    d64 = {k: a.astype(np.float64) if a.dtype == np.float32 else a for k, a in d.items()}
    ref, _ = step(interop.implicit_state_from_numpy(d64, "cpu"))
    assert ref.p.dtype == ref.e.dtype == ref.j.dtype == torch.float64
    ulp = np.spacing(np.abs(d["p"])).astype(np.float64)
    sign = np.where(np.arange(ulp.size) % 2 == 0, 1.0, -1.0)
    moved, _ = step(interop.implicit_state_from_numpy(
        dict(d64, p=d64["p"] + 0.5 * ulp * sign), "cpu"))
    assert int(tm.picard_iters) == int(jm.picard_iters) == 4
    for k in ("p", "v", "e", "j"):
        exact = getattr(ref, k).numpy()
        delta_s = _gap(exact, getattr(moved, k).numpy(), k, ng)
        port = _gap(exact, getattr(tst1, k).numpy(), k, ng)
        jax_ = _gap(exact, getattr(jst1, k), k, ng)
        assert port <= ROUNDINGS * delta_s, (k, port, delta_s)
        assert jax_ <= ROUNDINGS * delta_s, (k, jax_, delta_s)
        assert _gap(getattr(jst1, k), getattr(tst1, k).numpy(), k, ng) <= (
            2 * ROUNDINGS * delta_s), k
    # the position's ulp is the scale: delta_s spans a few of them
    assert _gap(ref.p.numpy(), moved.p.numpy(), "p", ng) < 8 * np.spacing(np.float32(ng))


def test_explicit_step_at_32768_matches_jax():
    """One explicit step of the two-stream load at ng = 32,768 through the
    fused path for ng > 1,024 (leapfrog_gather_push_deposit, then the
    solve): JAX's Pallas kernel in interpret mode against the port's plain
    version, from one shared state. The push sees the same field, so p1
    and v1 are the same float32 operations: p1 within one ulp of p at ng,
    2^-8 cells (measured 2^-9), v1 within 1e-6 (measured equal); rho1
    within 2e-5 of its largest node, the CPU tests' deposit limit
    (measured equal). The field solve of rho1 is the float32 spectral
    solve of both packages, whose low-k eigenvalues 2 cos(2 pi k / ng) - 2
    cancel at this grid: the two FFT libraries put e1 apart by their
    rounding of those modes (measured 6.8e-4 of its largest value), held
    to 1e-3 as tests/test_torch_explicit.py holds rho and the field energy
    over 50 steps."""
    ng, length, x, v, params = _two_stream_load(n=65_536, ng=NG)
    jcfg, tcfg = _explicit_configs(ng, length, params, backend="fused")
    jst = jexplicit.init_state(x, v, -E_CHARGE, M_ELECTRON, jcfg)
    d = {k: np.asarray(getattr(jst, k)) for k in interop._EXPLICIT_FIELDS}
    jst1, jm = jexplicit.make_step(jcfg)(jst)
    cuda_cic.reset_launch_counts()
    tst1, tm = explicit.make_step(tcfg)(interop.explicit_state_from_numpy(d, "cpu"))
    ulp = float(np.spacing(np.float32(ng)))
    assert _gap(jst1.p, tst1.p.numpy(), "p", ng) <= ulp
    assert _gap(jst1.v, tst1.v.numpy(), "v", ng) <= 1e-6
    assert _gap(jm.rho, tm.rho.numpy(), "rho", ng) <= 2e-5
    assert _gap(jst1.e, tst1.e.numpy(), "e", ng) <= 1e-3
    assert not any(cuda_cic.LAUNCHES.values())
