"""The Newton kernels' PCR system (csrc/newton.cu, ops/cuda_newton.py): the
rows it solves and the stages it runs.

The kernels solve ng rounded up to a warp (``cuda_newton.kernel_rows``),
one row a thread, where the TPU kernels (pypic_tpu/ops/pallas_newton.py)
solve the next power of two, at least 128 (``padded_rows``); and their
stages end once no row is coupled. Both change no value. The plain
versions follow the kernels, so here they are held bit for bit
(``torch.equal``: equal values, the sign of a zero aside) to the TPU's row
count and stage count, and to the Pallas kernels in interpret mode at the
edge shapes under tests/test_pallas.py's criteria. The kernels are held to
the plain versions on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pypic_tpu.ops.pallas_newton import boltzmann_dirichlet_pallas, boltzmann_dn_pallas

from pypic_tpu_torch.constants import E_CHARGE, EPSILON_0
from pypic_tpu_torch.ops import cuda_newton

TE, DX = 11600.0 * 10.0, 2e-5
N0_DD, N0_DN = np.float32(1e17), np.float32(0.9e17)


def _density(ng: int, seed: int) -> np.ndarray:
    """tests/test_pallas.py:315-389's number densities."""
    rng = np.random.default_rng(seed)
    return (1e17 * (1.0 + 0.3 * rng.standard_normal(ng))).clip(1e15).astype(np.float32)


def _pcr_every_stage(a, b, c, f):
    """The TPU kernels' PCR (pallas_newton.py:65-90): every stage while the
    stride is below the rows."""
    rows, s = a.shape[0], 1
    down, up = cuda_newton._shift_down, cuda_newton._shift_up
    while s < rows:
        am, bm, fm, cm = down(a, s, 0.0), down(b, s, 1.0), down(f, s, 0.0), down(c, s, 0.0)
        ap, bp, fp, cp = up(a, s, 0.0), up(b, s, 1.0), up(f, s, 0.0), up(c, s, 0.0)
        alpha = -a / bm
        gamma = -c / bp
        b = b + alpha * cm + gamma * ap
        f = f + alpha * fm + gamma * fp
        a = alpha * am
        c = gamma * cp
        s *= 2
    return f / b


def _first_newton_system(ng: int, rhs: int):
    """The physical rows (a, b, c, f) of the first Newton system from a cold
    start: the D-D kernel's (one right-hand side) or the D-N kernel's (two:
    the residual and e_{ng-1})."""
    c1, dx2, _, _ = cuda_newton.newton_scalars(TE, DX, 1e-9)
    dens = torch.from_numpy(_density(ng, 11 + ng))
    c0 = cuda_newton._COEF * 1e17
    jac_b = -dx2 * c0 * c1
    col = torch.arange(ng)
    inner = (col >= 1) & (col <= ng - 2)
    a = inner.to(torch.float32)
    c = inner.to(torch.float32)
    b = torch.where(inner, -2.0, 1.0) + jac_b
    f = torch.where(inner, -dx2 * c0 + dx2 * (E_CHARGE * dens / EPSILON_0), 0.0).float()
    if rhs == 1:
        return a, b.float(), c, f
    last = col == ng - 1
    a = torch.where(last, -4.0, a)
    b = torch.where(last, 3.0, b).float()
    return a, b, c, torch.stack([f, last.to(torch.float32)])


def _identity_padded(system, rows: int):
    a, b, c, f = system
    pad = rows - a.shape[0]
    z = torch.zeros(pad)
    fz = torch.zeros(f.shape[:-1] + (pad,))
    return (torch.cat([a, z]), torch.cat([b, z + 1.0]), torch.cat([c, z]),
            torch.cat([f, fz], dim=-1))


@pytest.mark.parametrize("rhs", [1, 2])
@pytest.mark.parametrize("ng", [3, 37, 128, 301, 600, 800, 1024])
def test_pcr_on_kernel_rows_matches_padded_rows(ng, rhs):
    """The plain PCR over kernel_rows(ng) rows, its stages ending at the
    last coupling, against every stage over padded_rows(ng) rows: equal
    solutions, and the rows past ng 0 in both."""
    system = _first_newton_system(ng, rhs)
    got = cuda_newton._pcr_solve(*_identity_padded(system, cuda_newton.kernel_rows(ng)))
    ref = _pcr_every_stage(*_identity_padded(system, cuda_newton.padded_rows(ng)))
    assert torch.equal(got[..., :ng], ref[..., :ng])
    assert not got[..., ng:].any() and not ref[..., ng:].any()
    assert got.shape[-1] == -(-ng // 32) * 32


@pytest.mark.parametrize("ng", [3, 31, 33, 600, 800, 1024])
@pytest.mark.parametrize("kind", ["dd", "dn"])
def test_plain_newton_solves_match_the_tpu_rows(ng, kind, monkeypatch):
    """Whole plain solves, cold and warm, on kernel_rows(ng) rows with the
    stages ending at the last coupling against the TPU's padded_rows(ng)
    rows and every stage: the same phi and iteration counts."""
    def solves():
        if kind == "dd":
            rho = torch.from_numpy(E_CHARGE * _density(ng, 11 + ng)).float()
            cold = cuda_newton.boltzmann_dirichlet_plain(rho, float(N0_DD), TE, DX, tol=1e-9)
            warm = cuda_newton.boltzmann_dirichlet_plain(rho, float(N0_DD), TE, DX, tol=1e-9,
                                                         phi0=cold.phi)
        else:
            n = torch.from_numpy(_density(ng, 13 + ng))
            cold = cuda_newton.boltzmann_dn_plain(n, float(N0_DN), TE, DX, torch.zeros(ng))
            warm = cuda_newton.boltzmann_dn_plain(n, float(N0_DN), TE, DX, cold.phi)
        return cold, warm

    got = solves()
    monkeypatch.setattr(cuda_newton, "kernel_rows", cuda_newton.padded_rows)
    monkeypatch.setattr(cuda_newton, "_pcr_solve", _pcr_every_stage)
    ref = solves()
    for g, r in zip(got, ref):
        assert torch.equal(g.phi, r.phi) and g.phi.shape == (ng,)
        assert int(g.iterations) == int(r.iterations)
        torch.testing.assert_close(g.residual, r.residual, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("ng", [31, 33, 1024])
def test_boltzmann_dirichlet_plain_matches_pallas_at_edge_rows(ng):
    """The D-D plain version (now on kernel_rows(ng) rows) against
    boltzmann_dirichlet_pallas in interpret mode at the row counts where
    the two differ most: test_pallas.py:315-342's criteria (counts within
    one cold, equal warm; phi within 3e-5 of max|phi|)."""
    rho = E_CHARGE * _density(ng, 11 + ng)
    ref = boltzmann_dirichlet_pallas(jnp.asarray(rho), N0_DD, TE, DX, tol=1e-9)
    got = cuda_newton.boltzmann_dirichlet(torch.from_numpy(rho), float(N0_DD), TE, DX,
                                          tol=1e-9)
    scale = float(jnp.max(jnp.abs(ref.phi)))
    assert float(got.residual) <= 1e-9
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(ref.phi), rtol=0,
                               atol=3e-5 * scale)
    ref_w = boltzmann_dirichlet_pallas(jnp.asarray(rho), N0_DD, TE, DX, tol=1e-9,
                                       phi0=ref.phi)
    got_w = cuda_newton.boltzmann_dirichlet(torch.from_numpy(rho), float(N0_DD), TE, DX,
                                            tol=1e-9, phi0=torch.from_numpy(np.array(ref.phi)))
    assert int(got_w.iterations) == int(ref_w.iterations)
    np.testing.assert_allclose(got_w.phi.numpy(), np.asarray(ref_w.phi), rtol=0,
                               atol=3e-5 * scale)


@pytest.mark.parametrize("ng", [33, 1024])
def test_boltzmann_dn_plain_matches_pallas_at_edge_rows(ng):
    """The D-N plain version (now on kernel_rows(ng) rows) against
    boltzmann_dn_pallas in interpret mode: test_pallas.py:361-389's
    criteria (counts within one cold, equal warm; phi within 5e-4 of
    max|phi|)."""
    n = _density(ng, 13 + ng)
    zero = np.zeros(ng, np.float32)
    ref = boltzmann_dn_pallas(jnp.asarray(n), N0_DN, TE, DX, jnp.asarray(zero))
    got = cuda_newton.boltzmann_dn(torch.from_numpy(n), float(N0_DN), TE, DX,
                                   torch.from_numpy(zero))
    scale = float(jnp.max(jnp.abs(ref.phi)))
    assert float(got.residual) <= 1e-3
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(ref.phi), rtol=0,
                               atol=5e-4 * scale)
    ref_w = boltzmann_dn_pallas(jnp.asarray(n), N0_DN, TE, DX, ref.phi)
    got_w = cuda_newton.boltzmann_dn(torch.from_numpy(n), float(N0_DN), TE, DX,
                                     torch.from_numpy(np.array(ref.phi)))
    assert int(got_w.iterations) == int(ref_w.iterations)
    np.testing.assert_allclose(got_w.phi.numpy(), np.asarray(ref_w.phi), rtol=0,
                               atol=5e-4 * scale)


def test_split_cuts_apply_to_the_newton_source():
    """tools/resident_split.py --kernel newton_dd|newton_dn cuts stages out
    of csrc/newton.cu by text edits; each anchor must stand in the source
    as many times as its edit says (the loop test once in each kernel),
    and each cut keeps both launchers."""
    from pypic_tpu_torch.ops import _build
    from pypic_tpu_torch.tools import resident_split

    src = (_build.CSRC_DIR / "newton.cu").read_text()
    cut = resident_split._edited(src, resident_split._NEWTON_EDITS)
    assert "int pypic_boltzmann_dirichlet(" in cut and "int pypic_boltzmann_dn(" in cut
    assert cut.count("while (forced >= 0 ? it < forced") == 2
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited(src.replace("pcr_solve<2>(x, buf, i, rows);", "x"),
                               resident_split._NEWTON_EDITS)
    with pytest.raises(RuntimeError, match="anchor"):
        resident_split._edited(src + "\n// while (residual > tol && it < maxiter) {\n",
                               resident_split._NEWTON_EDITS)
    assert set(resident_split.NEWTON_CUTS.values()) == set(range(7))
