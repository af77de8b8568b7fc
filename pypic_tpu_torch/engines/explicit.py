"""Explicit periodic electrostatic PIC engine (leapfrog).

The counterpart of ``pypic_tpu/engines/explicit.py``: the explicit cycle
deposit rho -> Poisson -> E -> gather -> leapfrog push -> periodic wrap
(PIC_L.py:604-786, cycle at 762-768; the intent of pypic.py:711-731).
The state carries rho and E of its positions, so a step is one particle
sweep: the push deposits its own output for the next step's solve.

``make_step`` picks one of three branches, as the JAX engine does
(explicit.py:165-229):

* ng <= 1024, scalar q/m: ``cuda_cic.explicit_cycle``, the whole cycle in
  one launch (the solve of the new rho runs in the kernel's epilogue);
* ng > 1024, scalar q/m: ``cuda_cic.leapfrog_gather_push_deposit``, then
  the FFT solve and the centered gradient;
* per-particle q/m (or ``backend='composed'``): the gather kernel,
  ``leapfrog_push``, ``torch.remainder``, the deposit kernel and the solve.

``run_resident`` runs ``steps_per_call`` cycles per launch of
``cuda_cic.explicit_cycle_resident`` (n <= 32768, a float32 state).

Data parallel (``cfg.axis_name`` set, ``make_step(cfg, mesh=mesh)``; see
``parallel.dataparallel``): each rank's deposit of rho is summed over the
ranks before the replicated solve, so the carried rho and e stay global.
The one-kernel cycle solves inside its own launch, where no sum can sit
between the deposit and the solve: under ``axis_name`` the fused backend
takes the two-stage sweep (``leapfrog_gather_push_deposit``, the sum,
then the solve) at every ng, as the JAX engine does. The kinetic energy
and the current bias are summed too.

Diagnostics use the physical definitions (field energy with the dx
measure, kinetic energy with one power of p2c), in the pre-push
convention: the metrics of step k describe the state it started from.
A step makes no host sync: q and m reach the kernel scalars from a host
copy taken when the state is built.

A float64 state (the JAX engine's under x64) runs on either device, its
scalars in float64: on the CPU through the plain versions, on the card
through the double kernels of all three branches (``explicit_cycle``,
``leapfrog_gather_push_deposit``, and the composed route's ``gather`` and
``deposit``). ``run_resident`` takes float32 only, as the JAX engine's
does (its resident scan carries float32).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import devices
from ..constants import EPSILON_0
from ..grid import GridSpec
from ..ops import cuda_cic
from ..ops.cic import deposit, gather
from ..ops.fd import grad_periodic
from ..ops.poisson import solve_periodic_neutralized
from ..parallel.dataparallel import ParticleAxis
from ..push import leapfrog_push

ONE_KERNEL_MAX_NG = 1024  # the one-kernel cycle's gate (explicit.py:155)


@dataclasses.dataclass(frozen=True)
class ExplicitConfig:
    """Same fields, defaults and validation as
    ``pypic_tpu.engines.explicit.ExplicitConfig``; see its comments for
    what each option means."""

    grid: GridSpec
    dt: float
    p2c: float
    deposit_method: str = "auto"
    backend: str = "auto"
    axis_name: str | None = None

    def __post_init__(self):
        # numpy scalars would otherwise promote float32 state
        object.__setattr__(self, "dt", float(self.dt))
        object.__setattr__(self, "p2c", float(self.p2c))
        if self.backend not in ("auto", "fused", "composed"):
            raise ValueError(f"unknown backend {self.backend!r}")


@dataclasses.dataclass
class ExplicitState:
    p: torch.Tensor  # (n,) positions in grid coordinates
    v: torch.Tensor  # (n,) velocities [m/s]
    q: torch.Tensor  # () or (n,) charge [C]
    m: torch.Tensor  # () or (n,) mass [kg]
    rho: torch.Tensor  # (ng,) charge density of p (the step's invariant)
    e: torch.Tensor  # (ng,) electric field of rho (the same invariant)
    step: torch.Tensor  # () int32
    # (q, m) as host floats, read once when the state is built, so that a
    # step makes no host sync; None for per-particle q/m
    qm_host: tuple[float, float] | None = dataclasses.field(default=None,
                                                            repr=False)

    def __post_init__(self):
        if self.qm_host is None and self.q.dim() == 0 and self.m.dim() == 0:
            self.qm_host = (self.q.item(), self.m.item())

    def replace(self, **changes) -> "ExplicitState":
        if "q" in changes or "m" in changes:
            changes.setdefault("qm_host", None)
        return dataclasses.replace(self, **changes)


class StepMetrics(NamedTuple):
    field_energy: torch.Tensor  # sum(eps0 E^2 dx / 2) [J/m^2]
    kinetic_energy: torch.Tensor  # p2c sum(m v^2 / 2)
    current_bias: torch.Tensor  # <j>
    rho: torch.Tensor  # (ng,) for field diagnostics
    e_field: torch.Tensor  # (ng,)


class ResidentMetrics(NamedTuple):
    """Per-step scalar metrics of run_resident, (steps,) each."""

    field_energy: torch.Tensor
    kinetic_energy: torch.Tensor
    current_bias: torch.Tensor


def _field(rho, dx: float):
    """The field of rho: the FFT solve and the centered gradient."""
    return -grad_periodic(solve_periodic_neutralized(rho, dx), dx)


def _fields(p, q, cfg: ExplicitConfig):
    """rho of the positions and its field."""
    grid = cfg.grid
    w = torch.broadcast_to(q * (cfg.p2c / grid.dx), p.shape).contiguous()
    rho = deposit(p, w, grid.ng, periodic=True, method=cfg.deposit_method)
    return rho, _field(rho, grid.dx).to(p.dtype)


def init_state(x, v, q, m, cfg: ExplicitConfig,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None) -> ExplicitState:
    """Wrap SI arrays from an initializer into engine state (grid
    coordinates) and deposit the initial charge density and its field
    (``state.rho`` and ``state.e`` always belong to ``state.p``).

    ``x`` [m] and ``v`` [m/s] are numpy arrays or tensors. ``device``
    defaults to x's device for a tensor and to the current CUDA device
    otherwise; without a card, pass ``device='cpu'``. Positions are cast to
    ``dtype`` and then divided by dx in that dtype, as the JAX engine does.
    """
    if isinstance(cfg, GridSpec):
        raise TypeError(
            "init_state now takes the ExplicitConfig (it needs p2c for the "
            "initial charge deposit), not a bare GridSpec")
    device = devices.resolve(device, like=x)
    cuda_cic.check_engine_dtype("explicit", device, dtype)
    grid = cfg.grid
    p = (torch.as_tensor(x, device=device).to(dtype)
         / torch.tensor(grid.dx, dtype=dtype, device=device))
    v = torch.as_tensor(v, device=device).to(dtype)
    q = torch.as_tensor(q, dtype=dtype, device=device)
    m = torch.as_tensor(m, dtype=dtype, device=device)
    rho, e = _fields(p, q, cfg)
    return ExplicitState(p=p, v=v, q=q, m=m, rho=rho, e=e,
                         step=torch.zeros((), dtype=torch.int32, device=device))


def refresh_fields(state: ExplicitState, cfg: ExplicitConfig) -> ExplicitState:
    """Recompute the carried rho/e from state.p (restores the step
    invariant after the positions were replaced)."""
    rho, e = _fields(state.p, state.q, cfg)
    return state.replace(rho=rho, e=e)


def _scalars(state: ExplicitState, cfg: ExplicitConfig):
    """(q/m, w, ke_c, jb_c) from the state's host q/m, as the JAX step
    computes them in the state's dtype: q/m and w = q (p2c / dx) are
    values of that dtype; ke_c = p2c m / 2 and jb_c = q p2c / (dx ng)
    scale the metric sums."""
    real = cuda_cic.real(state.p.dtype)
    q, m = (real(x) for x in state.qm_host)
    dx = cfg.grid.dx
    qm = float(q / m)
    w = float(q * real(cfg.p2c * (1.0 / dx)))
    return qm, w, 0.5 * cfg.p2c * float(m), float(q) * (cfg.p2c / dx / cfg.grid.ng)


def resident_kwargs(state: ExplicitState, cfg: ExplicitConfig) -> dict:
    """The keyword arguments of ``cuda_cic.explicit_cycle_resident`` (and
    its plain version) for this state: the step's scalars and the metric
    rows' constants."""
    qm, w, ke_c, jb_c = _scalars(state, cfg)
    return dict(qm=qm, w=w, ke_c=ke_c, jb_c=jb_c, dt=cfg.dt, dx=cfg.grid.dx,
                fe_c=0.5 * EPSILON_0 * cfg.grid.dx)


def make_step(cfg: ExplicitConfig, mesh=None):
    """Build the step: state -> (state, StepMetrics). ``mesh``: the rank's
    ``SlabMesh`` under ``cfg.axis_name`` (data parallel; None is one
    rank)."""
    ax = ParticleAxis(cfg.axis_name, mesh)
    grid = cfg.grid
    ng, dx, dt = grid.ng, grid.dx, cfg.dt
    dt_dx = dt / dx
    inv_dx = 1.0 / dx
    fe_c = 0.5 * EPSILON_0 * dx
    # the in-kernel epilogue solve would see only the rank's own deposit
    one_kernel = ng <= ONE_KERNEL_MAX_NG and cfg.axis_name is None

    def step(state: ExplicitState):
        cuda_cic.check_engine_dtype("explicit", state.p.device, state.p.dtype)
        scalar_qm = state.q.dim() == 0 and state.m.dim() == 0
        if cfg.backend == "fused" and not scalar_qm:
            raise ValueError(
                "backend='fused' requires scalar q/m (per-particle charge/"
                "mass arrays need backend='composed'; 'auto' picks it)")
        use_fused = cfg.backend == "fused" or (cfg.backend == "auto"
                                               and scalar_qm)
        e = state.e
        if use_fused:
            qm, w, ke_c, jb_c = _scalars(state, cfg)
            if one_kernel:
                p1, v1, rho1, e1 = cuda_cic.explicit_cycle(
                    e, state.p, state.v, ng, qm=qm, w=w, dt=dt, dx=dx)
            else:
                p1, v1, rho1 = cuda_cic.leapfrog_gather_push_deposit(
                    e, state.p, state.v, qm=qm, w=w, dt=dt, dx=dx)
                rho1 = ax.sum(rho1)
                e1 = _field(rho1, dx)
            # pre-push metrics; periodic CIC weights sum to 1, so the mean
            # of the current deposit is q w sum(v) / ng in closed form
            kinetic = ke_c * torch.dot(state.v, state.v)
            bias = jb_c * torch.sum(state.v)
        else:
            e_p = gather(e, state.p, periodic=True)
            p1, v1 = leapfrog_push(state.p, state.v, e_p, state.q / state.m,
                                   dt, dt_dx)
            p1 = torch.remainder(p1, ng)
            w_rho = torch.broadcast_to(state.q * (cfg.p2c * inv_dx), p1.shape)
            rho1 = ax.sum(deposit(p1, w_rho.contiguous(), ng, periodic=True,
                                  method=cfg.deposit_method))
            e1 = _field(rho1, dx)
            kinetic = 0.5 * cfg.p2c * torch.sum(state.m * state.v * state.v)
            bias = torch.sum(torch.broadcast_to(state.q, state.p.shape)
                             * state.v) * (cfg.p2c * inv_dx / ng)
        if ax.mesh is not None:
            kinetic, bias = ax.sum_many([kinetic.to(e.dtype),
                                         bias.to(e.dtype)])
        metrics = StepMetrics(
            field_energy=fe_c * torch.sum(e * e),
            kinetic_energy=kinetic,
            current_bias=bias,
            rho=state.rho,
            e_field=e,
        )
        return state.replace(p=p1, v=v1, rho=rho1, e=e1.to(p1.dtype),
                             step=state.step + 1), metrics

    return step


def run_resident(cfg: ExplicitConfig, state: ExplicitState, steps: int,
                 steps_per_call: int = 128):
    """Run ``steps`` explicit cycles, ``steps_per_call`` of them per launch
    of ``cuda_cic.explicit_cycle_resident``: the population stays on chip
    for the whole launch, so the per-step cost is the kernel's, not the
    host's.

    The same math as the one-kernel cycle. Requires scalar q/m, a
    float32 state, ng <= 1024 and n <= 32768, and accepts and rejects what
    the JAX engine's run_resident does. Returns (final_state,
    ResidentMetrics) with the metrics stacked over all ``steps``, as
    runner.run stacks StepMetrics.
    """
    ng = cfg.grid.ng
    if cfg.axis_name is not None:
        raise ValueError("run_resident is single-device (axis_name=None)")
    if state.q.dim() != 0 or state.m.dim() != 0:
        raise ValueError("run_resident requires scalar q/m")
    if state.p.dtype != torch.float32:
        # the JAX engine's resident scan carries float32 and raises a
        # TypeError for any other state
        raise NotImplementedError(
            f"run_resident takes a float32 state only, as the JAX engine's "
            f"does, not {state.p.dtype}: "
            f"{cuda_cic.F64_ITEMS['explicit_cycle_resident']}")
    if ng > ONE_KERNEL_MAX_NG:
        raise ValueError(
            f"run_resident requires ng <= {ONE_KERNEL_MAX_NG} (the field and "
            "its solve live in each block's shared memory)")
    if int(steps) <= 0 or int(steps_per_call) <= 0:
        raise ValueError(
            f"steps and steps_per_call must be >= 1, got "
            f"{steps}/{steps_per_call}")
    spc = min(int(steps_per_call), int(steps))
    full, rem = divmod(int(steps), spc)
    consts = resident_kwargs(state, cfg)
    rows = []
    for chunk in [spc] * full + ([rem] if rem else []):
        p1, v1, rho1, e1, fe, ke, jb = cuda_cic.explicit_cycle_resident(
            state.e, state.p, state.v, ng, chunk, **consts)
        state = state.replace(p=p1, v=v1, rho=rho1, e=e1,
                              step=state.step + chunk)
        rows.append((fe, ke, jb))
    return state, ResidentMetrics(*(torch.cat(col) for col in zip(*rows)))
