"""Domain-decomposed implicit CN-Picard engine, slab-sharded fields (the
counterpart of ``pypic_tpu/parallel/domain_implicit.py``), on
``torch.distributed``: BASELINE configs[4].

The grid never exists whole. The Ampere-law field advance
``E1 = E0 + (dt/eps0)(<jh> - smooth(jh))`` (pypic.py:283) is local up to a
summed scalar (the mean) and a radius-1 binomial stencil (a 1-node halo),
so E and j stay slab-sharded through the Picard loop:

* each pass gathers the smoothed field guess from a halo-extended slab
  (``halo + 2`` nodes a side), pushes in slab coordinates and deposits the
  half-step current onto the extended slab, folding the halos back to
  their owners (``domain.halo_fold``);
* the residual ``||Es - Eh||^2`` and the current mean are sums over the
  ranks, so every rank runs the same number of passes;
* particles whose excursion passes the halo are clamped to its edge for
  the grid work and counted (``n_halo_clamped``);
* after the loop the positions wrap to the global grid and migrate to
  their owners (``domain.migrate``).

Backends: 'fused' (and 'auto' on the card) runs each pass as one launch of
``ops.cuda_domain.picard_iteration_ext`` and finalizes with
``picard_finalize_ext_nodep`` (``finalize='converged'``) or
``picard_finalize_ext`` (``'converged-deposit'``), both with the wrap and
the step statistics in the sweep; 'composed' assembles the pass from the
``gather`` and ``deposit`` kernels and returns the last iterate.

The Picard loop: at a tolerance at or below ``DEVICE_LOOP_TOL`` (the
conserving configuration, tol 1e-30 and maxiter 4) the loop is expected to
run to maxiter, so the fused backend runs maxiter passes without reading
the residual: an int32 flag on the card, ``r > tol`` so far, gates each
pass's kernel (``active``) and each (c,) update, so a pass after
convergence changes nothing and the count is exact. One rank then makes
no host sync in a step. Above it (and on the composed backend) the host
reads the summed residual once a pass, as the single-device engine does.
With more than one rank, ``migrate`` reads its counts once a round.

Slabs x replicas (``num_replicas`` R > 1 with ``dp_axis_name``; JAX's
two-axis mesh): the ranks form ``mesh.make_mesh2(num_shards, R)``, and
rank s R + r holds replica r of slab s: the columns r::R of the slab's
rows (``init_state``), the fields slab-sharded and the same on every
replica. Each slab deposit is summed over the slab's replicas after the
halo fold, so the replicas of a slab iterate on the same field; the
particle statistics are summed over the whole mesh, and ``migrate`` rides
each replica's own ring of slabs with its round count summed over the
whole mesh, so every rank runs the same rounds. ``make_step`` and
``init_state`` take the rank's ``Mesh2`` (or a one-axis ``SlabMesh`` at
R = 1).

``picard_accel`` 'anderson'/'anderson2' sum their inner products over
the slabs (``ops.accel``'s ``reduce``), so mixing the slabs equals mixing
the global field; ``finalize_field`` ('map', 'mean2', 'aitken') redirects
the fused finalize sweep, the aitken inner products summed over the
slabs too (the composed backend has no finalize sweep and refuses it, as
JAX's does). The replicas of a slab hold equal fields: nothing sums over
them.

``make_superstep(cfg, mesh, k)`` (JAX's migration-amortized superstep)
runs k CN-Picard micro-steps and wraps and migrates once, after the last.
The fused micro-steps carry raw positions in shifted slab coordinates:
the finalize of a micro-step before the last runs its kernel with
``lo_shift`` 0 and ``ng`` 0 (the position kept raw, the statistics
accumulated), the last with ``lo - hw`` and ``ng`` (the global wrap). The
composed micro-steps carry local coordinates and wrap outside. One
function makes ``make_step`` and ``make_superstep``: superstep(k=1) is the
per-step path with a (1,) axis on its metrics.
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
from ..ops import cuda_domain
from ..ops.accel import (anderson2_mix, anderson_mix, damped_mix,
                         finalize_field, keep_history, mix_init)
from ..ops.cic import deposit, gather
from ..ops.fd import grad_periodic
from ..ops.poisson import solve_periodic_neutralized
from .domain import (_check_mesh, distribute_by_slab,
                     halo_extend, halo_fold, migrate, slot_weights)
from .mesh import Mesh2, SlabMesh

# at or below this tolerance the fused Picard loop runs maxiter passes
# gated on the card instead of reading the residual on the host. The
# choice is of launch pattern, not of result: the gated loop stops
# updating where the host loop would stop, so both give the same state
# and counts at any tol. It pays maxiter launches, which is what a loop
# that runs to maxiter costs anyway: tolerances that no residual is meant
# to reach, as the conserving configuration's tol 1e-30 (bench.py's
# fixed-iteration knob, maxiter 4). Tolerances set to converge (the
# default 1e-3, 1e-6, bench's --throughput 1e-9) lie far above 1e-20
# and keep the host loop, which stops at the pass that converges.
DEVICE_LOOP_TOL = 1e-20


@dataclasses.dataclass(frozen=True)
class DomainImplicitConfig:
    """Same fields, defaults and validation as
    ``pypic_tpu.parallel.domain_implicit.DomainImplicitConfig``; see its
    comments for what each option means."""

    grid: GridSpec  # periodic; ng must divide by num_shards
    dt: float
    p2c: float
    num_shards: int
    tol: float = 1e-3  # on ||Es - Eh||^2 (pypic.py:859)
    maxiter: int = 20  # pypic.py:860
    halo: int = 4  # max intra-step particle excursion, cells
    migrate_cap: int = 4096
    smooth: bool = True
    picard_init: str = "field"
    finalize: str = "converged"
    finalize_field: str = "last"
    backend: str = "auto"
    picard_accel: str = "none"
    window_share: str = "auto"
    axis_name: str = "slabs"
    deposit_method: str = "auto"
    dp_axis_name: str | None = None
    num_replicas: int = 1

    def __post_init__(self):
        for f in ("dt", "p2c", "tol"):
            object.__setattr__(self, f, float(getattr(self, f)))
        for f in ("maxiter", "halo", "migrate_cap", "num_shards",
                  "num_replicas"):
            object.__setattr__(self, f, int(getattr(self, f)))
        if self.grid.ng % self.num_shards:
            raise ValueError(
                f"ng={self.grid.ng} not divisible by {self.num_shards} shards"
            )
        if (self.num_replicas > 1) != (self.dp_axis_name is not None):
            raise ValueError(
                "num_replicas > 1 requires dp_axis_name (and vice versa)"
            )
        if self.halo + 3 > self.cells_per_shard:
            raise ValueError(
                f"halo={self.halo} too large for {self.cells_per_shard}-cell "
                "slabs (need halo + 3 <= cells_per_shard)"
            )
        if self.picard_init not in ("field", "extrapolate", "extrapolate2"):
            raise ValueError(f"unknown picard_init {self.picard_init!r}")
        if self.finalize not in ("converged", "converged-deposit", "iterate"):
            raise ValueError(f"unknown finalize {self.finalize!r}")
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
        if self.picard_accel not in ("none", "anderson", "anderson2",
                                     "damped"):
            raise ValueError(f"unknown picard_accel {self.picard_accel!r}")
        if self.backend not in ("auto", "fused", "composed"):
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def cells_per_shard(self) -> int:
        return self.grid.ng // self.num_shards


@dataclasses.dataclass
class DomainImplicitState:
    """One rank's particles and its slabs of the fields."""

    p: torch.Tensor  # (capacity,) global grid coordinates
    v: torch.Tensor  # (capacity,) [m/s]
    alive: torch.Tensor  # (capacity,) bool
    q: torch.Tensor  # () [C]
    m: torch.Tensor  # () [kg]
    e: torch.Tensor  # (c,) [V/m], this rank's slab
    j: torch.Tensor  # (c,) [A/m^2]
    e_prev: torch.Tensor  # (c,) previous-step field
    e_prev2: torch.Tensor  # (c,) field two steps back
    step: torch.Tensor  # () int32
    # (q, m) as host floats, read once when the state is built
    qm_host: tuple[float, float] | None = dataclasses.field(default=None,
                                                            repr=False)

    def __post_init__(self):
        if self.qm_host is None:
            self.qm_host = (float(self.q), float(self.m))

    def replace(self, **changes) -> "DomainImplicitState":
        if "q" in changes or "m" in changes:
            changes.setdefault("qm_host", None)
        return dataclasses.replace(self, **changes)


class StepMetrics(NamedTuple):
    field_energy: torch.Tensor
    kinetic_energy: torch.Tensor
    current_bias: torch.Tensor
    picard_iters: torch.Tensor
    picard_residual: torch.Tensor
    n_alive: torch.Tensor
    n_migrated: torch.Tensor
    n_dropped: torch.Tensor
    n_halo_clamped: torch.Tensor  # final-iterate excursions beyond the halo
    # deposits clamped at the shared-window edge (window_share='shared',
    # fused backend; 0 otherwise)
    picard_clamped: torch.Tensor


def _meshes(cfg: DomainImplicitConfig, mesh) -> Mesh2:
    """(slabs, replicas, world) of a rank's mesh: a ``Mesh2``, or a
    one-axis ``SlabMesh`` at num_replicas 1, checked against the config."""
    if isinstance(mesh, SlabMesh):
        if cfg.num_replicas > 1:
            raise ValueError(f"num_replicas={cfg.num_replicas} needs the "
                             "rank's Mesh2 (mesh.make_mesh2)")
        mesh = Mesh2(mesh, SlabMesh(0, 1, mesh.device), mesh)
    _check_mesh(cfg, mesh.slabs)
    if mesh.replicas.world != cfg.num_replicas:
        raise ValueError(f"num_replicas={cfg.num_replicas} but the mesh has "
                         f"{mesh.replicas.world} replicas a slab")
    return mesh


def replica_columns(blocks, r: int, num_replicas: int):
    """Replica r's columns r::R of (S, capacity) slab blocks, padded with
    zeros to JAX's per-replica capacity ceil(capacity / R) rounded up to
    128 (the (S, R, cap_r) layout of ``pypic_tpu``'s init_state)."""
    cap = blocks.shape[1]
    cap_r = -(-cap // num_replicas)
    cap_r = -(-cap_r // 128) * 128
    cols = blocks[:, r::num_replicas]
    out = torch.zeros((blocks.shape[0], cap_r), dtype=blocks.dtype,
                      device=blocks.device)
    out[:, :cols.shape[1]] = cols
    return out


def init_state(x, v, q, m, cfg: DomainImplicitConfig, mesh,
               capacity_factor: float = 1.5,
               device=None) -> DomainImplicitState:
    """This rank's state: the initial Poisson solve for E0 and the deposit
    of j0 on the whole grid (pypic.py:549-554; every rank is handed the
    whole load x [m], v [m/s] and computes them alike), then the rank's
    particles (with replicas, its replica's columns of its slab's rows)
    and field slabs. ``device`` defaults to the mesh's."""
    m2 = _meshes(cfg, mesh)
    mesh = m2.slabs
    device = devices.resolve(device if device is not None else mesh.device)
    grid = cfg.grid
    ng, dx = grid.ng, grid.dx
    x = torch.as_tensor(x, device=device)
    p_glob = (x / dx).to(torch.float32)
    v_glob = torch.as_tensor(v, device=device).to(torch.float32)
    w = float(np.float32(float(q) * (cfg.p2c / dx)))
    rho0 = deposit(p_glob, torch.full_like(p_glob, w), ng, periodic=True,
                   method=cfg.deposit_method)
    j0 = deposit(p_glob, w * v_glob, ng, periodic=True,
                 method=cfg.deposit_method)
    phi0 = solve_periodic_neutralized(rho0, dx)
    phi0 = phi0 - torch.max(phi0)
    e0 = (-grad_periodic(phi0, dx)).to(torch.float32)
    (p_out, v_out), alive, _ = distribute_by_slab(
        [p_glob, v_glob], x, cfg, capacity_factor, shards=[mesh.rank])
    if cfg.num_replicas > 1:
        r, reps = m2.replicas.rank, cfg.num_replicas
        p_out, v_out, alive = (replica_columns(a, r, reps)
                               for a in (p_out, v_out, alive))
    c = cfg.cells_per_shard
    own = slice(mesh.rank * c, (mesh.rank + 1) * c)
    # the slab's replicas take replica 0's fields: on the card the set-up
    # deposits add in float atomics, whose order differs between ranks,
    # and replicas that iterate on different bits could part in the loop
    e_own = m2.replicas.broadcast(e0[own].clone())
    j0 = m2.replicas.broadcast(j0[own].clone())
    return DomainImplicitState(
        p=p_out[0], v=v_out[0], alive=alive[0],
        q=torch.tensor(q, dtype=torch.float32, device=device),
        m=torch.tensor(m, dtype=torch.float32, device=device),
        e=e_own, j=j0, e_prev=e_own, e_prev2=e_own,
        step=torch.zeros((), dtype=torch.int32, device=device))


def make_step(cfg: DomainImplicitConfig, mesh):
    """The per-step-migration stepper of this rank: state -> (state,
    StepMetrics). ``mesh``: the rank's ``SlabMesh``, or its ``Mesh2``
    (slabs x replicas)."""
    return _make_stepper(cfg, mesh, None)


def make_superstep(cfg: DomainImplicitConfig, mesh, migrate_every: int):
    """The migration-amortized superstep of this rank: ``migrate_every``
    CN-Picard micro-steps back to back, then one wrap and one migration.
    Every metric gains a leading (migrate_every,) axis, one row a
    micro-step; ``n_migrated``/``n_dropped`` land in the last slot and
    ``n_alive`` there counts the survivors of migration; ``state.step``
    advances by ``migrate_every``.

    The extended-slab gathers and deposits are exact for any excursion
    within ``cfg.halo`` cells of the slab; rows past it are clamped for
    the grid work and counted in ``n_halo_clamped`` each micro-step: size
    ``halo >= migrate_every v_max dt / dx``."""
    k_mig = int(migrate_every)
    if k_mig < 1:
        raise ValueError(f"migrate_every must be >= 1, got {k_mig}")
    return _make_stepper(cfg, mesh, k_mig)


def _make_stepper(cfg: DomainImplicitConfig, mesh, k_mig):
    """Makes both steppers: ``k_mig`` None is the per-step path (0-d
    metrics), k the k-micro-step superstep (stacked metrics)."""
    m2 = _meshes(cfg, mesh)
    mesh = m2.slabs
    ng, dx, dt = cfg.grid.ng, cfg.grid.dx, cfg.dt
    dt_dx = dt / dx
    c = cfg.cells_per_shard
    d = mesh.rank
    h = cfg.halo
    hw = h + 2  # +1 smoothing stencil, +1 CIC right node
    ext_n = c + 2 * hw + 1
    use_fused = cfg.backend == "fused" or (
        cfg.backend == "auto" and mesh.device.type == "cuda")
    if not use_fused and cfg.finalize_field != "last":
        raise ValueError(
            "finalize_field != 'last' requires the fused backend (the "
            "composed path returns the last Picard iterate's arrays and "
            "has no finalize sweep to redirect); backend='auto' resolves "
            "to composed off the card: set backend='fused' explicitly "
            "(its plain kernels run on the CPU too)")
    # clamp bounds in shifted (halo/deposit) coordinates: xi in [-h, c+h]
    clamp_lo_s = float(hw - h)
    clamp_hi_s = float(c + h + hw)
    tol = float(np.float32(cfg.tol))  # the loop compares float32 values
    device_loop = use_fused and cfg.tol <= DEVICE_LOOP_TOL
    emit_v = cfg.finalize == "iterate"
    share = cfg.window_share == "shared"
    n_hist = keep_history(cfg.finalize_field, emit_v)
    total = mesh.all_reduce_sum  # over the slabs (fields, replicated)
    total_all = m2.world.all_reduce_sum  # over every rank (particles)
    dpsum = m2.replicas.all_reduce_sum  # over the slab's replicas
    weights = slot_weights()

    def fold(ext):
        """A slab deposit: the halo fold, then the sum over the replicas."""
        return dpsum(halo_fold(ext, c, hw, mesh))

    def smooth3(ext):
        return 0.25 * (ext[:-2] + 2.0 * ext[1:-1] + ext[2:])

    def smooth_own(f_own):
        """Periodic binomial smoother of a slab-sharded field: the radius-1
        stencil over a 1-node halo (equals smooth_periodic globally)."""
        left, right = mesh.ring_exchange(f_own[-1:], f_own[:1])
        return smooth3(torch.cat([left, f_own, right]))

    def smoothed_ext(es):
        """The field guess halo-extended (and smoothed) in the shifted
        deposit coordinates (ext_n nodes); with smoothing the two end
        nodes are zero padding outside the clamp range, never gathered."""
        e_ext = halo_extend(es, hw, mesh)
        if not cfg.smooth:
            return e_ext
        z = torch.zeros((1,), dtype=e_ext.dtype, device=e_ext.device)
        return torch.cat([z, smooth3(e_ext), z])

    def ampere(es, jh, e0):
        """Ampere advance (pypic.py:283), half-step field and residual."""
        j_mean = total(torch.sum(jh)) / ng
        e1 = e0 + (dt / EPSILON_0) * (
            j_mean - (smooth_own(jh) if cfg.smooth else jh))
        eh = 0.5 * (e1 + e0)
        return e1, eh, total(torch.sum((es - eh) ** 2))

    def mix(es, eh, k, aux):
        # the inner products sum over the slabs; the replicas of a slab
        # hold equal fields, so nothing sums over them
        if cfg.picard_accel == "anderson":
            return anderson_mix(es, eh, k, aux, reduce=total)
        if cfg.picard_accel == "anderson2":
            return anderson2_mix(es, eh, k, aux, reduce=total)
        if cfg.picard_accel == "damped":
            return damped_mix(es, eh, k, aux)
        return eh, aux

    def init_guess(e0, e_prev, e_prev2):
        if cfg.picard_init == "extrapolate":
            return e0 + 0.5 * (e0 - e_prev)
        if cfg.picard_init == "extrapolate2":
            return 0.125 * (15.0 * e0 - 10.0 * e_prev + 3.0 * e_prev2)
        return e0

    def slab_deposit(pl, val):
        ext = deposit(torch.clamp(pl, -float(h), float(c + h)) + hw,
                      val.contiguous(), ext_n, periodic=False,
                      method=cfg.deposit_method)
        return fold(ext)

    def loop_fused(e0, j_in, es, p0s, v0, w, qm, ps):
        """The fused Picard loop. Returns (es, ps, v1 of the last pass or
        None, e1, jh, r, k, n_clamped, ef); k is an int32 tensor and ef
        the field of the finalize sweep."""
        dev = p0s.device
        aux = mix_init(e0, cfg.picard_accel)
        hist = (es,) * n_hist  # the last map outputs, seeded with es0
        e1, jh, v1 = e0, j_in, None
        r = torch.full((), math.inf, dtype=e0.dtype, device=dev)
        ncl = torch.zeros((), dtype=torch.int32, device=dev)
        go = torch.ones((1,), dtype=torch.int32, device=dev)
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        r_host, k = math.inf, 0
        kw = dict(qm=qm, dt=dt, dx=dx, lo=clamp_lo_s, hi=clamp_hi_s,
                  emit_v=emit_v, shared=share)
        while k < cfg.maxiter and (device_loop or r_host > tol):
            if k == 0:  # fresh outputs: ps is the seed (or p0s itself)
                outs = cuda_domain.picard_iteration_ext(
                    smoothed_ext(es), ps, p0s, v0, w, **kw)
            else:  # in place over the previous iterate
                outs = cuda_domain.picard_iteration_ext(
                    smoothed_ext(es), ps, p0s, v0, w, out=(ps, v1),
                    active=go if device_loop else None, **kw)
            jh_k = fold(outs[1 + emit_v])
            e1_k, eh, r_k = ampere(es, jh_k, e0)
            es_k, aux_k = mix(es, eh, k, aux)
            hist_k = ((eh,) + hist[:-1]) if n_hist else ()
            ps = outs[0]
            if emit_v:
                v1 = outs[1]
            if share:
                ncl = ncl + outs[-1]  # 0 from a skipped pass
            if device_loop:
                on = go[0] != 0
                e1 = torch.where(on, e1_k, e1)
                jh = torch.where(on, jh_k, jh)
                r = torch.where(on, r_k, r)
                es = torch.where(on, es_k, es)
                aux = tuple(torch.where(on, a, b) for a, b in zip(aux_k, aux))
                hist = tuple(torch.where(on, a, b)
                             for a, b in zip(hist_k, hist))
                iters = iters + go[0]
                go = go * (r > tol).to(torch.int32)
            else:
                e1, jh, r, es, aux, hist = e1_k, jh_k, r_k, es_k, aux_k, hist_k
                iters = iters + 1
            k += 1
            if not device_loop and k < cfg.maxiter:
                r_host = float(r)  # the one host read of the pass
        ef = finalize_field(es, hist, iters if device_loop else k,
                            cfg.finalize_field, reduce=total)
        return es, ps, v1, e1, jh, r, iters, ncl, ef

    def loop_composed(e0, j_in, es, p0l, v0, w, qm_t):
        """The op-composed Picard loop (host reads): the last iterate's
        (p1l, v1, e1, j1, r, k)."""
        aux = mix_init(e0, cfg.picard_accel)
        psl, p1l, v1, e1, j1 = p0l, p0l, v0, e0, j_in
        r = torch.full((), math.inf, dtype=e0.dtype, device=e0.device)
        r_host, k = math.inf, 0
        while r_host > tol and k < cfg.maxiter:
            # gather the smoothed field guess at the position guess
            # (pypic.py:261) from the halo-extended slab
            e_ext = halo_extend(es, hw, mesh)
            g_ext, off = (smooth3(e_ext), hw - 1) if cfg.smooth else (e_ext, hw)
            e_p = gather(g_ext, torch.clamp(psl, -float(h), float(c + h)) + off,
                         periodic=False)
            # Crank-Nicolson update in slab coordinates (pypic.py:264-265)
            accel = qm_t * e_p
            p1l = p0l + dt_dx * v0 + (0.5 * dt * dt_dx) * accel
            v1 = v0 + dt * accel
            phl = 0.5 * (p0l + p1l)
            jh = slab_deposit(phl, w * (0.5 * (v0 + v1)))
            j1 = slab_deposit(p1l, w * v1)
            e1, eh, r = ampere(es, jh, e0)
            es, aux = mix(es, eh, k, aux)
            psl = phl
            k += 1
            if k < cfg.maxiter:
                r_host = float(r)  # the one host read of the pass
        return p1l, v1, e1, j1, r, k

    def micro_fused(p0s, v0, fields, alive, w, qm, lo, last):
        """One fused micro-step from shifted coordinates p0s: (p1, v1, e1,
        j1, row). p1 is global and wrapped on the last micro-step, raw and
        shifted before it; row = (kinetic sum, mean j1, k, r, clamped,
        shared-window clamps)."""
        e0, j_in, e_prev, e_prev2 = fields
        es0 = init_guess(e0, e_prev, e_prev2)
        seed = p0s + (0.5 * dt_dx) * v0 if share else p0s
        es, pss, v1, e1, jh, r, k, ncl, ef = loop_fused(
            e0, j_in, es0, p0s, v0, w, qm, seed)
        if emit_v:
            # the last Picard iterate (pypic.py:293-295): p1 from its v1
            # elementwise, in shifted coordinates; jh drove the advance
            p1 = p0s + (0.5 * dt_dx) * (v0 + v1)
            j1 = jh
            mean_j1 = total_all(torch.sum(w * v1)) / ng
            nhc = total_all((alive & ((p1 < clamp_lo_s) | (p1 > clamp_hi_s))
                             ).sum(dtype=torch.int64))
            kin_sum = total_all(torch.sum(torch.where(alive, v1 * v1, 0.0)))
            if last:
                p1 = torch.remainder(p1 + (lo - hw), ng)
        else:
            # the finalize sweep: ng 0 keeps the position raw and shifted
            # before the last micro-step; the statistics accumulate on
            # every one
            fin = (cuda_domain.picard_finalize_ext_nodep
                   if cfg.finalize == "converged"
                   else cuda_domain.picard_finalize_ext)
            outs = fin(smoothed_ext(ef), pss, p0s, v0, w, qm=qm, dt=dt, dx=dx,
                       lo=clamp_lo_s, hi=clamp_hi_s,
                       lo_shift=(lo - hw) if last else 0.0,
                       ng=ng if last else 0)
            p1, v1, st = outs[0], outs[1], outs[-1]
            if cfg.finalize == "converged":
                # the half-step current drove the Ampere advance
                j1 = jh
                mean_j1 = total_all(st[0].to(torch.float32)) / ng
            else:
                j1 = fold(outs[2])
                mean_j1 = total(torch.sum(j1)) / ng
            kin_sum = total_all(st[1].to(torch.float32))
            nhc = total_all(st[2].to(torch.int64))
        return p1, v1, e1, j1, (kin_sum, mean_j1, k, r, nhc, ncl)

    def micro_composed(p0l, v0, fields, alive, w, qm_t):
        """One composed micro-step from local coordinates p0l: (p1l raw,
        v1, e1, j1, row)."""
        e0, j_in, e_prev, e_prev2 = fields
        es0 = init_guess(e0, e_prev, e_prev2)
        p1l, v1, e1, j1, r, k = loop_composed(e0, j_in, es0, p0l, v0, w, qm_t)
        nhc = total_all(
            (alive & ((p1l < -h) | (p1l > c + h))).sum(dtype=torch.int64))
        kin_sum = total_all(torch.sum(torch.where(alive, v1 * v1, 0.0)))
        mean_j1 = total(torch.sum(j1)) / ng
        k = torch.tensor(k, dtype=torch.int32, device=v1.device)
        return p1l, v1, e1, j1, (kin_sum, mean_j1, k, r, nhc, None)

    def step(state: DomainImplicitState):
        alive = state.alive
        dev = alive.device
        lo = float(np.float32(d * c))
        q32 = np.float32(state.qm_host[0])
        qm = float(q32 / np.float32(state.qm_host[1]))
        # dead slots are inert: their deposit weight is 0, and migration,
        # the metrics and the clamp counts mask by alive
        w = weights(alive, float(q32 * np.float32(cfg.p2c / dx)))
        fields = (state.e, state.j, state.e_prev, state.e_prev2)
        # shifted deposit coordinates (fused; p - lo is exact near the
        # slab, so this is (p - lo) + hw rounded once, as JAX computes it)
        # or local ones (composed)
        p = state.p - (lo - hw) if use_fused else state.p - lo
        v = state.v
        rows = []
        k_tot = k_mig or 1
        for i in range(k_tot):
            last = i == k_tot - 1
            if use_fused:
                p, v, e1, j1, row = micro_fused(p, v, fields, alive, w, qm,
                                                lo, last)
            else:
                p, v, e1, j1, row = micro_composed(p, v, fields, alive, w,
                                                   state.q / state.m)
            rows.append((e1,) + row)
            # the next micro-step's (e, j, e_prev, e_prev2)
            fields = (e1, j1, fields[0], fields[1])
        if not use_fused:
            p = torch.remainder(p + lo, ng)  # wrap to global coordinates
        (p2, v2), alive1, n_migrated, n_dropped = migrate(
            [p, v], alive, d, ng=ng, cells_per_shard=c,
            num_shards=cfg.num_shards, cap=cfg.migrate_cap, mesh=mesh,
            count_mesh=m2.world)
        n_alive1 = total_all(torch.count_nonzero(alive1))
        zero = torch.zeros((), dtype=torch.int32, device=dev)

        def metrics_of(row, n_alive, n_mig, n_drop):
            e1, kin_sum, mean_j1, k, r, nhc, ncl = row
            return StepMetrics(
                field_energy=0.5 * EPSILON_0 * dx * total(torch.sum(e1 * e1)),
                kinetic_energy=0.5 * cfg.p2c * state.m * kin_sum,
                current_bias=mean_j1,
                picard_iters=k,
                picard_residual=r,
                n_alive=n_alive,
                n_migrated=n_mig,
                n_dropped=n_drop,
                n_halo_clamped=nhc,
                picard_clamped=(total_all(ncl) if ncl is not None else zero))

        if k_mig is None:
            metrics = metrics_of(rows[0], n_alive1, n_migrated, n_dropped)
        else:
            n_alive0 = (total_all(torch.count_nonzero(alive)) if k_mig > 1
                        else None)
            ms = [metrics_of(row, n_alive0, zero, zero) for row in rows[:-1]]
            ms.append(metrics_of(rows[-1], n_alive1, n_migrated, n_dropped))
            metrics = StepMetrics(*(torch.stack(col) for col in zip(*ms)))
        e_c, j_c, ep_c, ep2_c = fields
        new_state = state.replace(
            p=p2, v=v2, alive=alive1, e=e_c, j=j_c, e_prev=ep_c,
            e_prev2=ep2_c, step=state.step + k_tot)
        return new_state, metrics

    return step
