"""Implicit energy-conserving periodic PIC engine (Crank-Nicolson + Picard).

The counterpart of ``pypic_tpu/engines/implicit.py``: the reference's
``particle_push_p`` (pypic.py:216-300) and its time loop ``implicit_pic``
(pypic.py:472-651).

* ``step_fused`` (scalar q/m): each Picard pass is one particle sweep
  (``ops.cuda_cic.picard_iteration``: gather, CN push, half-step current
  deposit; ``picard_iteration_shared`` with ``window_share='shared'``);
  the Ampere advance, the residual and Anderson mixing are small (ng,)
  tensor work; a finalize sweep recomputes (p1, v1) from the converged
  half-step field (``picard_finalize_nodep``, or ``picard_finalize`` with
  the full-step current for ``finalize='converged-deposit'``).
* ``step_composed`` (per-particle q/m, or ``backend='composed'``): the
  gather kernel, a PyTorch CN push and two deposit kernels a pass; it
  returns the last Picard iterate, as the reference does.
* ``run_resident``: ``steps_per_call`` whole fused steps a launch of
  ``ops.cuda_cic.implicit_resident``, for n <= 131072.

The per-step Picard loop runs on the host: it reads the residual once per
pass (one device sync per pass, none after the last allowed pass).
``run_resident`` keeps the loop on the card and makes no host sync between
launches.

Data parallel (``cfg.axis_name`` set, ``make_step(cfg, mesh=mesh)``; see
``parallel.dataparallel``): each rank holds a block of the particles; each
pass's deposit, the finalize's, the kinetic energy and the current-bias
sum are summed over the ranks before they are used, so the Ampere advance,
the residual and the exit test read the same bits on every rank and every
rank runs the same passes. The tracer is rank 0's particle.

``picard_accel`` 'anderson2' mixes over two histories (``ops.accel``),
and ``finalize_field`` redirects the finalize sweep's field ('map': the
last Picard map output; 'mean2': the mean of the last two; 'aitken': a
Delta^2 extrapolation over the last three), as the JAX engine's do; the
fused loop keeps those map outputs on the device and adds no host read.
``deposit_method`` picks the standalone deposits' reduction
(``ops.cic.deposit``).

A float64 state (``init_state(..., dtype=torch.float64)``), as the JAX
engine runs it under x64: the step's host scalars and the residual test
round to the state's dtype, as JAX's weakly typed scalars do, and the
kernels are the double ones of ``ops.cuda_cic`` (rows 1-6) on the card,
the plain versions on the CPU, on both backends and with every option.
``run_resident`` takes float32 only, as the JAX engine's (its scan
carry); 'scatter' and 'matmul' deposits (``deposit_det``) have no double
kernel yet and raise on the card.
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
from ..ops.accel import (anderson2_mix, anderson_mix, damped_mix,
                         finalize_field, keep_history, mix_init)
from ..ops.cic import deposit, gather
from ..ops.fd import grad_periodic, smooth_periodic
from ..ops.poisson import solve_periodic_neutralized
from ..parallel.dataparallel import ParticleAxis


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
    # the Ampère advance (finalize 'converged' and 'iterate'); the
    # full-step j1 under 'converged-deposit' and on the composed backend.
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
    # deposits clamped at the shared-window edge, summed over the passes
    # (window_share='shared'; always 0 on the separate-window, composed and
    # resident paths)
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
    grid = cfg.grid
    ng, dx = grid.ng, grid.dx
    device = devices.resolve(device, like=x)
    p = (torch.as_tensor(x, device=device) / dx).to(dtype)
    v = torch.as_tensor(v, device=device).to(dtype)
    q = torch.as_tensor(q, dtype=dtype, device=device)
    m = torch.as_tensor(m, dtype=dtype, device=device)
    w = torch.broadcast_to(q * (cfg.p2c / dx), p.shape).contiguous()
    rho0 = deposit(p, w, ng, periodic=True, method=cfg.deposit_method)
    j0 = deposit(p, w * v, ng, periodic=True, method=cfg.deposit_method)
    phi0 = solve_periodic_neutralized(rho0, dx)
    phi0 = phi0 - torch.max(phi0)
    e0 = (-grad_periodic(phi0, dx)).to(dtype)
    return ImplicitState(
        p=p, v=v, q=q, m=m, e=e0, j=j0.to(dtype), e_prev=e0, e_prev2=e0,
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_step(cfg: ImplicitConfig, mesh=None):
    """Build the implicit step: state -> (state, StepMetrics). ``mesh``:
    the rank's ``SlabMesh`` under ``cfg.axis_name`` (data parallel; None
    is one rank)."""
    ax = ParticleAxis(cfg.axis_name, mesh)
    ng = cfg.grid.ng
    dx = cfg.grid.dx
    dt = cfg.dt
    dt_dx = dt / dx
    inv_dx = 1.0 / dx
    emit_v = cfg.finalize == "iterate"
    share = cfg.window_share == "shared"  # 'auto' is 'separate'
    n_hist = keep_history(cfg.finalize_field, emit_v)

    def _smooth(f):
        return smooth_periodic(f) if cfg.smooth else f

    def _wrap(x):
        return x - torch.floor(x * (1.0 / ng)) * ng

    def _es0(state: ImplicitState):
        """Initial Picard iterate (see ImplicitConfig.picard_init)."""
        if cfg.picard_init == "extrapolate":
            return state.e + 0.5 * (state.e - state.e_prev)
        if cfg.picard_init == "extrapolate2":
            return 0.125 * (15.0 * state.e - 10.0 * state.e_prev
                            + 3.0 * state.e_prev2)
        return state.e

    def _mix(es, eh, k, aux):
        # the field is whole on every rank under axis_name: the inner
        # products need no sum over the ranks
        if cfg.picard_accel == "anderson":
            return anderson_mix(es, eh, k, aux)
        if cfg.picard_accel == "anderson2":
            return anderson2_mix(es, eh, k, aux)
        if cfg.picard_accel == "damped":
            return damped_mix(es, eh, k, aux)
        return eh, aux

    def _advance(e0, es, jh):
        """Ampere advance, half-step field and residual of one pass."""
        e1 = e0 + (dt / EPSILON_0) * (torch.mean(jh) - _smooth(jh))
        eh = 0.5 * (e1 + e0)
        return e1, eh, torch.sum((es - eh) ** 2)

    def _metrics(state, e1, p1, v1, current_bias, k, r, clamped):
        dev = e1.device
        kinetic = 0.5 * cfg.p2c * torch.sum(state.m * v1 * v1)
        if ax.mesh is None:
            # clones: a view would keep the whole (n,) array alive
            tracer = (p1[cfg.tracer].clone(), v1[cfg.tracer].clone())
        else:
            # the kinetic sum and rank 0's tracer over the ranks in one
            # collective (current_bias arrives summed)
            t = (torch.stack([p1[cfg.tracer], v1[cfg.tracer]]) if ax.rank == 0
                 else torch.zeros(2, dtype=p1.dtype, device=dev))
            kinetic, t = ax.sum_many([kinetic.to(p1.dtype), t])
            tracer = (t[0], t[1])
            if clamped is not None:
                clamped = ax.sum(clamped)
        return StepMetrics(
            field_energy=0.5 * EPSILON_0 * dx * torch.sum(e1 * e1),
            kinetic_energy=kinetic,
            current_bias=current_bias,
            picard_iters=torch.full((), k, dtype=torch.int32, device=dev),
            picard_residual=r,
            tracer_x=tracer[0],
            tracer_v=tracer[1],
            picard_clamped=(clamped if clamped is not None else
                            torch.zeros((), dtype=torch.int32, device=dev)),
        )

    def step_fused(state: ImplicitState):
        """One particle sweep per Picard pass, then the finalize sweep.

        finalize='converged' recomputes (p1, v1) from the converged
        half-step field with one extra sweep ('converged-deposit' also
        deposits the full-step current j1 in it); finalize='iterate'
        returns the last Picard iterate like the reference
        (pypic.py:293-295), with p1 rebuilt elementwise from the iterate's
        v1.
        """
        p0, v0, e0 = state.p, state.v, state.e
        dev = e0.device
        # scalars on the host in the state's dtype, as the JAX step
        # computes them; the residual test compares values of that dtype
        real = cuda_cic.real(e0.dtype)
        q = real(state.qm_host[0])
        qm_s = q / real(state.qm_host[1])
        w_s = q * real(cfg.p2c * inv_dx)
        tol = float(real(cfg.tol))

        es = _es0(state)
        if share:
            # free-streaming midpoint seed: keeps the deposit's offset from
            # the gather's window frame at an acceleration displacement
            ps = _wrap(p0 + (0.5 * dt_dx) * v0)
            clamped = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            ps = p0  # the reference's first gather position (pypic.py:253)
            clamped = None
        sweep = (cuda_cic.picard_iteration_shared if share
                 else cuda_cic.picard_iteration)
        e1, jh, v1 = e0, state.j, v0
        r = torch.full((), math.inf, dtype=e0.dtype, device=dev)
        r_host, k = math.inf, 0
        aux = mix_init(e0, cfg.picard_accel)
        # the last map outputs (eh_k, eh_{k-1}, ...), seeded with es0
        hist = (es,) * n_hist
        while r_host > tol and k < cfg.maxiter:
            outs = sweep(_smooth(es), ps, p0, v0, ng, qm=qm_s, w=w_s, dt=dt,
                         dx=dx, emit_v=emit_v)
            if share:
                clamped = clamped + outs[-1]
                outs = outs[:-1]
            jh = ax.sum(outs[-1])
            e1, eh, r = _advance(e0, es, jh)
            es, aux = _mix(es, eh, k, aux)
            if n_hist:
                hist = (eh,) + hist[:-1]
            ps = outs[0]
            if emit_v:
                v1 = outs[1]
            k += 1
            if k < cfg.maxiter:
                r_host = r.item()  # the one host sync of the pass

        # the finalize sweeps gather smooth(ef) at the last ph: ef is es
        # AFTER the last mix, or what finalize_field makes of the history
        ef = finalize_field(es, hist, k, cfg.finalize_field)
        if cfg.finalize == "converged-deposit":
            p1, v1, j1 = cuda_cic.picard_finalize(
                _smooth(ef), ps, p0, v0, ng, qm=qm_s, w=w_s, dt=dt, dx=dx)
            j1 = ax.sum(j1)
            current_bias = torch.mean(j1)
        else:
            if emit_v:
                # p1 of the same iterate: qm dt^2/2 e_p == dt/dx (v1 - v0)/2
                p1 = _wrap(p0 + (0.5 * dt_dx) * (v0 + v1))
            else:
                p1, v1 = cuda_cic.picard_finalize_nodep(
                    _smooth(ef), ps, p0, v0, ng, qm=qm_s, dt=dt, dx=dx)
            j1 = jh  # the half-step current that drove the Ampere advance
            # Exact grid mean of the skipped full-step deposit: periodic
            # CIC weights sum to 1, so mean(deposit(p1, w v1)) == w
            # sum(v1)/ng.
            current_bias = ax.sum(torch.sum(v1)) * float(w_s / real(ng))
        metrics = _metrics(state, e1, p1, v1, current_bias, k, r, clamped)
        new_state = state.replace(p=p1, v=v1, e=e1, j=j1, e_prev=state.e,
                                  e_prev2=state.e_prev, step=state.step + 1)
        return new_state, metrics

    def step_composed(state: ImplicitState):
        """Op-composed step (per-particle q/m capable): per pass the gather
        kernel, a PyTorch CN push and two deposit kernels (jh at ph, j1 at
        p1). Returns the LAST Picard iterate and its full-step current, as
        the reference loop body does (pypic.py:274-295); cfg.finalize and
        cfg.window_share apply to the fused step only."""
        p0, v0, e0 = state.p, state.v, state.e
        qm = state.q / state.m
        w = state.q * (cfg.p2c * inv_dx)  # deposit prefactor q p2c / dx
        tol = float(cuda_cic.real(e0.dtype)(cfg.tol))

        es = _es0(state)
        ps = p0
        p1, v1, e1, j1 = p0, v0, e0, state.j
        r = torch.full((), math.inf, dtype=e0.dtype, device=e0.device)
        r_host, k = math.inf, 0
        aux = mix_init(e0, cfg.picard_accel)
        while r_host > tol and k < cfg.maxiter:
            # gather the smoothed field guess at the position guess
            # (pypic.py:261), Crank-Nicolson update (pypic.py:264-265)
            accel = qm * gather(_smooth(es), ps, periodic=True)
            p1 = p0 + dt_dx * v0 + (0.5 * dt * dt_dx) * accel
            v1 = v0 + dt * accel
            # half-step quantities and the periodic wrap (pypic.py:267-279)
            ph = torch.remainder(0.5 * (p0 + p1), ng)
            jh = deposit(ph, (w * (0.5 * (v0 + v1))).contiguous(), ng,
                         periodic=True, method=cfg.deposit_method)
            p1 = torch.remainder(p1, ng)
            j1 = deposit(p1, (w * v1).contiguous(), ng, periodic=True,
                         method=cfg.deposit_method)
            jh, j1 = ax.sum_many([jh, j1])
            e1, eh, r = _advance(e0, es, jh)
            es, aux = _mix(es, eh, k, aux)
            ps = ph
            k += 1
            if k < cfg.maxiter:
                r_host = r.item()  # the one host sync of the pass

        metrics = _metrics(state, e1, p1, v1, torch.mean(j1), k, r, None)
        new_state = state.replace(p=p1, v=v1, e=e1, j=j1, e_prev=state.e,
                                  e_prev2=state.e_prev, step=state.step + 1)
        return new_state, metrics

    def step(state: ImplicitState):
        scalar_qm = state.q.dim() == 0 and state.m.dim() == 0
        if cfg.backend == "fused" and not scalar_qm:
            raise ValueError(
                "backend='fused' requires scalar q/m (the fused pass bakes "
                "them into kernel scalars); use backend='composed' or "
                "'auto' for per-particle q/m arrays")
        if cfg.backend == "fused" or (cfg.backend == "auto" and scalar_qm):
            return step_fused(state)
        return step_composed(state)

    return step


def check_resident_supported(cfg: ImplicitConfig,
                             state: ImplicitState) -> None:
    """Raise ValueError when (cfg, state) is outside run_resident's
    supported space, with the JAX engine's answers and messages. It decides
    from host facts (shapes and the config) only: it builds and launches
    nothing."""
    if state.q.dim() != 0 or state.m.dim() != 0:
        raise ValueError("run_resident requires scalar q/m")
    if state.p.dtype != torch.float32:
        # the JAX engine's resident scan carries float32 and raises a
        # TypeError for any other state
        raise NotImplementedError(
            f"run_resident takes a float32 state only, as the JAX engine's "
            f"does, not {state.p.dtype}: {cuda_cic.F64_ITEMS['implicit_resident']}")
    if cfg.backend == "composed":
        # the composed step returns the reference's LAST-ITERATE semantics;
        # the resident kernel implements the converged fused step
        raise ValueError("run_resident implements the fused backend only "
                         "(backend='composed' selects last-iterate "
                         "semantics; use the scanned step)")
    if cfg.grid.ng > 1024:
        raise ValueError("run_resident requires ng <= 1024 (VMEM operators)")
    if state.p.shape[0] > cuda_cic.RESIDENT_MAX_N_IMPLICIT:
        raise ValueError(
            f"run_resident requires n <= {cuda_cic.RESIDENT_MAX_N_IMPLICIT}")
    if cfg.axis_name is not None:
        raise ValueError("run_resident is single-device (axis_name=None)")
    if cfg.picard_init not in ("field", "extrapolate"):
        raise ValueError("run_resident supports picard_init "
                         "'field'/'extrapolate'")
    if cfg.picard_accel not in ("none", "anderson"):
        raise ValueError("run_resident supports picard_accel "
                         "'none'/'anderson'")
    if cfg.finalize != "converged" or cfg.finalize_field != "last":
        raise ValueError("run_resident supports finalize='converged', "
                         "finalize_field='last'")
    if cfg.window_share == "shared":
        raise ValueError("run_resident implements the separate-window pass "
                         "only (use the scanned step for window_share="
                         "'shared')")


def resident_kwargs(state: ImplicitState, cfg: ImplicitConfig) -> dict:
    """The keyword arguments of ``cuda_cic.implicit_resident`` (and its
    plain version) for this state: float32 scalars as the JAX engine's
    resident path computes them, and the config's loop options."""
    q, m = (np.float32(x) for x in state.qm_host)
    dx = cfg.grid.dx
    return dict(
        qm=float(q / m), w=float(q * np.float32(cfg.p2c / dx)),
        ke_c=float(np.float32(0.5 * cfg.p2c) * m), dt=cfg.dt, dx=dx,
        tol=cfg.tol, maxiter=cfg.maxiter,
        extrapolate=cfg.picard_init == "extrapolate",
        anderson=cfg.picard_accel == "anderson",
        fe_c=0.5 * EPSILON_0 * dx, tracer=cfg.tracer, smooth=cfg.smooth)


def run_resident(cfg: ImplicitConfig, state: ImplicitState, steps: int,
                 steps_per_call: int = 64):
    """Run ``steps`` implicit CN-Picard steps, ``steps_per_call`` whole
    steps (Picard loop included) per launch of
    ``cuda_cic.implicit_resident``: ``divmod(steps, steps_per_call)`` full
    launches, then one for the rest, with no host sync between them. At
    small n the per-step path is bound by the host (a sync and a dozen
    launches per Picard pass); here the loop stays on the card.

    The same math as the fused step with finalize='converged',
    finalize_field='last' and separate windows (picard_init
    'field'/'extrapolate', picard_accel 'none'/'anderson', smooth on or
    off); ``check_resident_supported`` raises for anything else. Positions
    agree with ``runner.run`` to float32 summation order, not bit for bit.

    Returns (final_state, StepMetrics) with every metric stacked over all
    ``steps``, as runner.run stacks them; picard_clamped is 0. As in the
    JAX engine, the returned e_prev2 is the previous CHUNK's e_prev (exact
    only at steps_per_call=1); it feeds only picard_init='extrapolate2',
    which this path rejects.
    """
    check_resident_supported(cfg, state)
    if int(steps) <= 0 or int(steps_per_call) <= 0:
        raise ValueError(
            f"steps and steps_per_call must be >= 1, got "
            f"{steps}/{steps_per_call}")
    spc = min(int(steps_per_call), int(steps))
    full, rem = divmod(int(steps), spc)
    consts = resident_kwargs(state, cfg)
    rows = []
    for chunk in [spc] * full + ([rem] if rem else []):
        p1, v1, e1, eprev, jh, r = cuda_cic.implicit_resident(
            state.e, state.e_prev, state.j, state.p, state.v, cfg.grid.ng,
            chunk, **consts)
        state = state.replace(p=p1, v=v1, e=e1, j=jh, e_prev=eprev,
                              e_prev2=state.e_prev, step=state.step + chunk)
        rows.append(r)
    cat = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    metrics = StepMetrics(
        field_energy=cat["fe"],
        kinetic_energy=cat["ke"],
        current_bias=cat["jb"],
        picard_iters=cat["iters"],
        picard_residual=cat["resid"],
        tracer_x=cat["tracer_x"],
        tracer_v=cat["tracer_v"],
        picard_clamped=torch.zeros_like(cat["iters"]),
    )
    return state, metrics
