"""Implicit energy-conserving periodic PIC engine (Crank-Nicolson + Picard).

The counterpart of ``pypic_tpu/engines/implicit.py``, fused backend: the
reference's ``particle_push_p`` (pypic.py:216-300) and its driver
``implicit_pic`` (pypic.py:472-651). Each Picard pass is one particle sweep
(``ops.cuda_cic.picard_iteration``: gather, CN push, half-step current
deposit); the Ampère advance, the residual and Anderson mixing are small
(ng,) tensor work; a finalize sweep recomputes (p1, v1) from the converged
half-step field.

The Picard loop runs on the host: it reads the residual once per pass
(one device sync per pass, none after the last allowed pass). A
device-resident loop captured in a CUDA graph is later work (ROADMAP.md
queue 1, item 11).

Options that need modules or kernels not ported yet raise
``NotImplementedError`` from ``make_step``, naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import devices
from ..constants import EPSILON_0
from ..grid import GridSpec
from ..ops import cuda_cic
from ..ops.accel import anderson_mix, damped_mix, mix_init
from ..ops.cic import deposit
from ..ops.fd import grad_periodic, smooth_periodic
from ..ops.poisson import solve_periodic_neutralized


@dataclasses.dataclass(frozen=True)
class ImplicitConfig:
    """Same fields, defaults and validation as
    ``pypic_tpu.engines.implicit.ImplicitConfig``; see its comments for
    what each option means."""

    grid: GridSpec
    dt: float
    p2c: float
    tol: float = 1e-3  # on ||Es - Eh||^2 (pypic.py:859)
    maxiter: int = 20  # pypic.py:860
    deposit_method: str = "auto"
    tracer: int = 0  # tracer particle index for trajectory diagnostics
    backend: str = "auto"
    smooth: bool = True
    axis_name: str | None = None
    picard_init: str = "field"
    finalize: str = "converged"
    picard_accel: str = "none"
    finalize_field: str = "last"
    window_share: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "dt", float(self.dt))
        object.__setattr__(self, "p2c", float(self.p2c))
        object.__setattr__(self, "tol", float(self.tol))
        object.__setattr__(self, "maxiter", int(self.maxiter))
        if self.picard_init not in ("field", "extrapolate", "extrapolate2"):
            raise ValueError(f"unknown picard_init {self.picard_init!r}")
        if self.finalize not in ("converged", "converged-deposit", "iterate"):
            raise ValueError(f"unknown finalize {self.finalize!r}")
        if self.picard_accel not in ("none", "anderson", "anderson2", "damped"):
            raise ValueError(f"unknown picard_accel {self.picard_accel!r}")
        if self.finalize_field not in ("last", "mean2", "map", "aitken"):
            raise ValueError(f"unknown finalize_field {self.finalize_field!r}")
        if self.finalize == "iterate" and self.finalize_field != "last":
            raise ValueError(
                "finalize='iterate' has no finalize sweep to redirect — "
                f"finalize_field={self.finalize_field!r} would be silently "
                "ignored; use finalize='converged' (or finalize_field='last')"
            )
        if self.window_share not in ("auto", "shared", "separate"):
            raise ValueError(f"unknown window_share {self.window_share!r}")
        if self.backend not in ("auto", "fused", "composed"):
            raise ValueError(f"unknown backend {self.backend!r}")


@dataclasses.dataclass
class ImplicitState:
    p: torch.Tensor  # (n,) positions in grid coordinates
    v: torch.Tensor  # (n,) velocities [m/s]
    q: torch.Tensor  # () charge [C]
    m: torch.Tensor  # () mass [kg]
    e: torch.Tensor  # (ng,) electric field [V/m]
    # (ng,) current density [A/m^2]: the HALF-step current jh that drove
    # the Ampère advance (finalize 'converged' and 'iterate').
    j: torch.Tensor
    e_prev: torch.Tensor  # (ng,) previous-step field
    e_prev2: torch.Tensor  # (ng,) field two steps back
    step: torch.Tensor  # () int32
    # (q, m) as host floats, read once when the state is built, so that a
    # step syncs with the device only for its residuals; None for
    # per-particle q/m
    qm_host: tuple[float, float] | None = dataclasses.field(default=None,
                                                            repr=False)

    def __post_init__(self):
        if self.qm_host is None and self.q.dim() == 0 and self.m.dim() == 0:
            self.qm_host = (self.q.item(), self.m.item())

    def replace(self, **changes) -> "ImplicitState":
        if "q" in changes or "m" in changes:
            changes.setdefault("qm_host", None)
        return dataclasses.replace(self, **changes)


class StepMetrics(NamedTuple):
    field_energy: torch.Tensor  # sum(eps0 E^2 dx / 2) (pypic.py:571)
    kinetic_energy: torch.Tensor  # p2c sum(m v^2 / 2) (pypic.py:572)
    current_bias: torch.Tensor  # <j> (pypic.py:574)
    picard_iters: torch.Tensor  # int32
    picard_residual: torch.Tensor
    tracer_x: torch.Tensor  # grid coords
    tracer_v: torch.Tensor
    # deposits clamped at the shared-window edge (always 0: the shared
    # window is not ported)
    picard_clamped: torch.Tensor


def init_state(x, v, q, m, cfg: ImplicitConfig,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None) -> ImplicitState:
    """Initial state incl. the initial Poisson solve for E0 and current j0
    (pypic.py:549-554).

    ``x`` [m] and ``v`` [m/s] are numpy arrays or tensors. ``device``
    defaults to x's device for a tensor and to the current CUDA device
    otherwise; without a card, pass ``device='cpu'``. Positions are divided
    by dx in x's own precision, then cast to ``dtype``.
    """
    _check_ported(cfg)
    grid = cfg.grid
    ng, dx = grid.ng, grid.dx
    device = devices.resolve(device, like=x)
    p = (torch.as_tensor(x, device=device) / dx).to(dtype)
    v = torch.as_tensor(v, device=device).to(dtype)
    q = torch.as_tensor(q, dtype=dtype, device=device)
    m = torch.as_tensor(m, dtype=dtype, device=device)
    w = torch.broadcast_to(q * (cfg.p2c / dx), p.shape).contiguous()
    rho0 = deposit(p, w, ng, periodic=True)
    j0 = deposit(p, w * v, ng, periodic=True)
    phi0 = solve_periodic_neutralized(rho0, dx)
    phi0 = phi0 - torch.max(phi0)
    e0 = (-grad_periodic(phi0, dx)).to(dtype)
    return ImplicitState(
        p=p, v=v, q=q, m=m, e=e0, j=j0.to(dtype), e_prev=e0, e_prev2=e0,
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _check_ported(cfg: ImplicitConfig) -> None:
    """Raise NotImplementedError for options whose modules or kernels are
    not ported yet."""
    todo = {
        f"deposit_method={cfg.deposit_method!r}": (
            cfg.deposit_method != "auto",
            "item 18, options measured negative or gated off"),
        "backend='composed'": (cfg.backend == "composed",
                               "item 7, step_composed with the gather kernel"),
        "finalize='converged-deposit'": (
            cfg.finalize == "converged-deposit",
            "item 8, finalize='converged-deposit'"),
        f"finalize_field={cfg.finalize_field!r}": (
            cfg.finalize_field != "last",
            "item 18, options measured negative or gated off"),
        "picard_accel='anderson2'": (
            cfg.picard_accel == "anderson2",
            "item 18, options measured negative or gated off"),
        "window_share='shared'": (
            cfg.window_share == "shared",
            "item 18, options measured negative or gated off"),
        "axis_name": (cfg.axis_name is not None,
                      "item 17, parallel, on torch.distributed"),
    }
    for what, (hit, item) in todo.items():
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet: see ROADMAP.md queue 1, {item}")


def make_step(cfg: ImplicitConfig):
    """Build the implicit step: state -> (state, StepMetrics)."""
    _check_ported(cfg)
    ng = cfg.grid.ng
    dx = cfg.grid.dx
    dt = cfg.dt
    dt_dx = dt / dx
    inv_dx = 1.0 / dx
    # the residual test compares float32 values, as the JAX loop does
    tol = float(np.float32(cfg.tol))
    emit_v = cfg.finalize == "iterate"

    def _smooth(f):
        return smooth_periodic(f) if cfg.smooth else f

    def _es0(state: ImplicitState):
        """Initial Picard iterate (see ImplicitConfig.picard_init)."""
        if cfg.picard_init == "extrapolate":
            return state.e + 0.5 * (state.e - state.e_prev)
        if cfg.picard_init == "extrapolate2":
            return 0.125 * (15.0 * state.e - 10.0 * state.e_prev
                            + 3.0 * state.e_prev2)
        return state.e

    def _mix(es, eh, k, aux):
        if cfg.picard_accel == "anderson":
            return anderson_mix(es, eh, k, aux)
        if cfg.picard_accel == "damped":
            return damped_mix(es, eh, k, aux)
        return eh, aux

    def step_fused(state: ImplicitState):
        """One particle sweep per Picard pass, then the finalize sweep.

        finalize='converged' recomputes (p1, v1) from the converged
        half-step field with one extra sweep; finalize='iterate' returns
        the last Picard iterate like the reference (pypic.py:293-295),
        with p1 rebuilt elementwise from the iterate's v1.
        """
        p0, v0, e0 = state.p, state.v, state.e
        dev = e0.device
        # float32 scalars on the host, as the JAX step computes them
        q = np.float32(state.qm_host[0])
        qm_s = q / np.float32(state.qm_host[1])
        w_s = q * np.float32(cfg.p2c * inv_dx)

        es = _es0(state)
        ps = p0  # the reference's first gather position (pypic.py:253)
        e1, jh, v1 = e0, state.j, v0
        r = torch.full((), math.inf, dtype=e0.dtype, device=dev)
        r_host, k = math.inf, 0
        aux = mix_init(e0, cfg.picard_accel)
        while r_host > tol and k < cfg.maxiter:
            outs = cuda_cic.picard_iteration(
                _smooth(es), ps, p0, v0, ng, qm=qm_s, w=w_s, dt=dt, dx=dx,
                emit_v=emit_v)
            jh = outs[-1]
            e1 = e0 + (dt / EPSILON_0) * (torch.mean(jh) - _smooth(jh))
            eh = 0.5 * (e1 + e0)
            r = torch.sum((es - eh) ** 2)
            es, aux = _mix(es, eh, k, aux)
            ps = outs[0]
            if emit_v:
                v1 = outs[1]
            k += 1
            if k < cfg.maxiter:
                r_host = r.item()  # the one host sync of the pass

        if emit_v:
            # p1 of the same iterate: qm dt^2/2 e_p == dt/dx (v1 - v0)/2
            p1 = p0 + (0.5 * dt_dx) * (v0 + v1)
            p1 = p1 - torch.floor(p1 * (1.0 / ng)) * ng
        else:
            # the finalize sweep gathers smooth(es) with es AFTER the last
            # mix, at the last ph
            p1, v1 = cuda_cic.picard_finalize_nodep(
                _smooth(es), ps, p0, v0, ng, qm=qm_s, dt=dt, dx=dx)
        # Exact grid mean of the skipped full-step deposit: periodic CIC
        # weights sum to 1, so mean(deposit(p1, w v1)) == w sum(v1)/ng.
        current_bias = torch.sum(v1) * float(w_s / np.float32(ng))

        metrics = StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * torch.sum(e1 * e1),
            kinetic_energy=0.5 * cfg.p2c * torch.sum(state.m * v1 * v1),
            current_bias=current_bias,
            picard_iters=torch.full((), k, dtype=torch.int32, device=dev),
            picard_residual=r,
            # clones: a view would keep the whole (n,) array alive
            tracer_x=p1[cfg.tracer].clone(),
            tracer_v=v1[cfg.tracer].clone(),
            picard_clamped=torch.zeros((), dtype=torch.int32, device=dev),
        )
        new_state = state.replace(p=p1, v=v1, e=e1, j=jh, e_prev=state.e,
                                  e_prev2=state.e_prev, step=state.step + 1)
        return new_state, metrics

    def step(state: ImplicitState):
        scalar_qm = state.q.dim() == 0 and state.m.dim() == 0
        if cfg.backend == "fused" and not scalar_qm:
            raise ValueError(
                "backend='fused' requires scalar q/m (the fused pass bakes "
                "them into kernel scalars); use backend='composed' or "
                "'auto' for per-particle q/m arrays")
        if not scalar_qm:
            raise NotImplementedError(
                "per-particle q/m runs on the composed backend, which is not "
                "ported yet: see ROADMAP.md queue 1, item 7, step_composed "
                "with the gather kernel")
        return step_fused(state)

    return step
