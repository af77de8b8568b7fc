"""The double kernels of a float64 state (rows 1-6) against their float64
plain versions, on the card. Every test here needs an NVIDIA GPU and skips
without one; the file imports no JAX:

    python -m pytest --noconftest tests/test_torch_float64_cuda.py -q

Inputs as tests/test_torch_cuda.py's (n = 4097, edge positions 0, ng - 1e-4
and ng), in float64, at ng = 64 (the shared mode) and 40,000 (above the
double kernels' ceilings: the global mode). The kernels round each
operation once in double as the plain versions do: positions, velocities
and the gather bit-equal, the deposits within 16 n eps64 of the largest
node (float64 sums in another order), the clamp counts equal. A float64
implicit step on the card stays float64 and agrees with the CPU's.
"""

import numpy as np
import pytest
import torch

from pypic_tpu_torch.constants import E_CHARGE, M_ELECTRON
from pypic_tpu_torch.engines import implicit
from pypic_tpu_torch.ops import cuda_cic
from pypic_tpu_torch.tools import headline

N = 4097
QM, W, DT, DX = -1.7e11, -3.2e-9, 1e-7, 0.05
TOL_SUM = 16 * N * 2.0 ** -52


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(ng, dev, seed=7):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, ng, N)
    v0 = rng.normal(size=N) * 1e5
    ps = rng.uniform(0, ng, N)
    e = rng.normal(size=ng) * 1e3
    edge = np.array([0.0, ng - 1e-4, ng])
    p0[:3] = edge
    ps[:3] = edge
    ps[3:6] = edge
    v0[:3] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (e, ps, p0, v0)]


def _rel(ref, got):
    return float((ref - got).abs().max() / ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 40_000])
@pytest.mark.parametrize("name", ["picard_iteration", "picard_iteration_shared",
                                  "picard_finalize_nodep", "picard_finalize"])
def test_double_pass_and_finalize_match_plain(cuda_device, name, ng):
    e, ps, p0, v0 = _inputs(ng, cuda_device)
    kw = dict(qm=QM, dt=DT, dx=DX, **({} if name == "picard_finalize_nodep" else dict(w=W)))
    if name.startswith("picard_iteration"):
        kw["emit_v"] = True
    cuda_cic.reset_launch_counts()
    got = getattr(cuda_cic, name)(e, ps, p0, v0, ng, **kw)
    ref = getattr(cuda_cic, f"{name}_plain")(e.cpu(), ps.cpu(), p0.cpu(), v0.cpu(), ng, **kw)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES[f"{name}_f64"] == 1 and cuda_cic.LAUNCHES[name] == 0
    mode = cuda_cic.sweep_launch(name, N, ng, 132, item=8).mode
    assert cuda_cic.LARGE_LAUNCHES.get(f"{name}_f64 global", 0) == (mode == "global")
    assert all(t.dtype == torch.float64 for t in got if t.dim() == 1)
    assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
    if name != "picard_finalize_nodep":
        assert _rel(ref[2], got[2].cpu()) <= TOL_SUM
    if name == "picard_iteration_shared":
        assert int(got[3]) == int(ref[3])


@pytest.mark.cuda
@pytest.mark.parametrize("ng", [64, 40_000])
@pytest.mark.parametrize("periodic", [True, False])
def test_double_deposit_and_gather_match_plain(cuda_device, ng, periodic):
    e, _, p0, v0 = _inputs(ng, cuda_device)
    pos = p0 if periodic else p0 * ((ng - 1) / ng)
    cuda_cic.reset_launch_counts()
    dep = cuda_cic.deposit(pos, v0 * W, ng, periodic=periodic)
    gat = cuda_cic.gather(e, pos, periodic=periodic)
    torch.cuda.synchronize()
    assert cuda_cic.LAUNCHES["deposit_f64"] == cuda_cic.LAUNCHES["gather_f64"] == 1
    assert dep.dtype == gat.dtype == torch.float64
    assert _rel(cuda_cic.deposit_plain(pos.cpu(), (v0 * W).cpu(), ng, periodic=periodic),
                dep.cpu()) <= TOL_SUM
    assert torch.equal(gat.cpu(), cuda_cic.gather_plain(e.cpu(), pos.cpu(), periodic=periodic))


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, dict(backend="composed"), dict(window_share="shared"),
                                  dict(finalize="converged-deposit")],
                         ids=["fused", "composed", "shared", "converged-deposit"])
def test_float64_implicit_step_card_matches_cpu(cuda_device, over):
    """One conserving float64 step of the headline physics at n = 20,000
    on the card and on the CPU from one state: p within 1e-10 cells, v, e
    and j within 1e-10 of their largest (float64 sums in other orders),
    the same Picard passes, only double kernels launched."""
    from pypic_tpu_torch import interop

    cfg = headline.headline_config(20_000, **over)
    x, v = headline.device_load(20_000, cfg.grid.length, "cpu")
    st = implicit.init_state(x.double(), v.double(), -E_CHARGE, M_ELECTRON, cfg,
                             dtype=torch.float64, device="cpu")
    d = interop.implicit_state_to_numpy(st)
    step = implicit.make_step(cfg)
    c, mc = step(st)
    cuda_cic.reset_launch_counts()
    g, mg = step(interop.implicit_state_from_numpy(d, cuda_device))
    torch.cuda.synchronize()
    assert g.p.dtype == g.e.dtype == g.j.dtype == torch.float64
    assert int(mc.picard_iters) == int(mg.picard_iters)
    launched = {k for k, n in cuda_cic.LAUNCHES.items() if n}
    assert launched and all(k.endswith("_f64") for k in launched), launched
    dp = (c.p - g.p.cpu()).abs()
    assert float(torch.minimum(dp, cfg.grid.ng - dp).max()) <= 1e-10
    for k in ("v", "e", "j"):
        assert _rel(getattr(c, k), getattr(g, k).cpu()) <= 1e-10, k
