"""Hybrid PIC <-> surface-model driver (the pic_bca_aps loop; the
counterpart of ``pypic_tpu/engines/bca_driver.py``).

The surface coupling is the reference's one process boundary: the
F-TRIDYN binary runs between PIC steps (pygcpic.py:1571-1572). The driver
keeps it: each block of ``pic_steps_per_bca`` engine steps runs through
``runner.run`` on the state's device with no host read; then the block's
metrics come to the host in one concatenated device-to-host copy, the
surface model runs on the wall-impact rows per (incident species -> wall)
channel in numpy, and its sputtered and reflected products go back into
free slots (``magnetized.make_inject``; pygcpic.py:1599-1625), whose
injected and dropped counts are a second read (as the JAX driver's), with
periodic checkpoints (pygcpic.py:1627-1632) and the yield and reflection
statistics (pygcpic.py:1468-1480).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import bca as bca_mod
from .. import checkpoint as ckpt_mod
from ..constants import K_BOLTZMANN
from ..parallel import dataparallel
from ..runner import run as run_steps
from . import magnetized


@dataclasses.dataclass
class BCAStats:
    """Per-run accumulated surface statistics (pygcpic.py:1408-1418)."""

    source_incident: int = 0
    wall_incident: int = 0
    sputtered: int = 0
    self_sputtered: int = 0
    source_sputtered: int = 0
    source_reflected: int = 0
    wall_reflected: int = 0
    injected: int = 0
    dropped: int = 0
    # wall-species impacts that were themselves wall-born (pic_bca_aps's
    # per-step `redeposited` counter, pygcpic.py:1521-1522); counted under
    # write_particles
    redeposited: int = 0
    # sheath-escape events whose .dat line the per-step row buffer's cap
    # dropped (the dynamics are not affected; write_particles only)
    escape_lines_dropped: int = 0

    def total_yield(self) -> float:
        inc = self.source_incident + self.wall_incident
        return self.sputtered / inc if inc else 0.0

    def source_reflection(self) -> float:
        return (self.source_reflected / self.source_incident
                if self.source_incident else 0.0)


def fetch(ms):
    """The stacked metrics of a block on the host in one device-to-host
    copy: every leaf flattened to float32 (counts are below 2^24 and the
    data is float32, so the round trip is exact) and concatenated; then
    cut back into numpy arrays of the leaves' shapes and dtypes."""
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in ms]).cpu()
    flat = flat.numpy()
    out, o = [], 0
    for leaf in ms:
        k = leaf.numel()
        np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        out.append(flat[o:o + k].reshape(tuple(leaf.shape)).astype(np_dtype))
        o += k
    return type(ms)(*out)


def _row(ms, i):
    return type(ms)(*(a[i] for a in ms))


def _inject_products(state, inject, new_rows, new_sides, stats, cfg, rng,
                     product_p2c, z_to_idx, wall_species_idx, t_now,
                     events=None, source_species_idx=0):
    """The surface model's products (rows [E_eV, ca, cb, cg, m_amu, Z] and
    the wall each leaves from) as particles in free slots
    (pygcpic.py:1599-1625); the batch is padded to a power of two with
    invalid rows, as the JAX driver pads it. With ``events`` (a
    write_particles directory) their launch vx / vth go to the
    {source,wall}_from_wall.dat streams."""
    rows = np.concatenate(new_rows)
    sides = np.concatenate(new_sides)
    batch = bca_mod.particles_from_energy_angle(
        rows, sides, cfg.dt, cfg.grid.length, product_p2c, rng)
    k = len(batch["x"])
    sp_idx = np.asarray([z_to_idx.get(int(z), wall_species_idx)
                         for z in batch["z"]], np.int32)
    if events is not None:
        # the products' launch vx / vth (pygcpic.py:1607-1621)
        t_samp = cfg.source.ti if cfg.source is not None else cfg.te
        vx_b = (np.asarray(batch["v"])[:, 0]
                / np.sqrt(K_BOLTZMANN * t_samp
                          / np.asarray(batch["m"], np.float64)))
        _append_events(events, "wall_from_wall.dat",
                       vx_b[sp_idx == wall_species_idx])
        _append_events(events, "source_from_wall.dat",
                       vx_b[sp_idx == source_species_idx])
    pad = max(8, 1 << (k - 1).bit_length()) - k

    def padded(a, dt_):
        a = np.asarray(a, dt_)
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], dt_)])

    state, n_inj, n_drop = inject(
        state,
        padded(batch["x"], np.float32), padded(batch["yz"], np.float32),
        padded(batch["v"], np.float32), padded(batch["m"], np.float32),
        padded(batch["charge_state"], np.float32),
        padded(batch["p2c"], np.float32), padded(sp_idx, np.int32),
        padded(np.full(k, t_now, np.float32), np.float32),
        np.concatenate([np.ones(k, bool), np.zeros(pad, bool)]))
    n_inj, n_drop = torch.stack([n_inj, n_drop]).cpu().tolist()  # one read
    stats.injected += int(n_inj)
    stats.dropped += int(n_drop)
    return state


def _surface(channels, stats, rng, num_histories: int, from_iead=None):
    """Run each channel's surface model and count its products; returns
    (product rows, the wall side of each). ``channels`` are (name,
    energies, angles, model) for the per-impact channel, or (name, delta
    histogram, model) with ``from_iead`` = (energy edges, angle edges)."""
    new_rows, new_sides = [], []
    for name, *inputs, iface in channels:
        if from_iead is None:
            energies, angles = inputs
            if energies.size == 0:
                continue
            sput, refl = iface.run(energies, angles,
                                   num_histories=num_histories)
        else:
            (d,) = inputs
            if int(round(d.sum())) == 0:
                continue
            sput, refl = iface.run_from_iead(*from_iead, d,
                                             num_histories=num_histories)
        stats.sputtered += len(sput)
        if name == "wall":
            stats.self_sputtered += len(sput)
            stats.wall_reflected += len(refl)
        else:
            stats.source_sputtered += len(sput)
            stats.source_reflected += len(refl)
        for rows in (sput, refl):
            if len(rows):
                new_rows.append(np.asarray(rows))
                # products leave from a random wall in the reference
                # (pygcpic.py:1607); kept
                new_sides.append(rng.integers(0, 2, len(rows)).astype(np.float64))
    return new_rows, new_sides


def run_bca(
    state: magnetized.MagnetizedState,
    cfg: magnetized.MagnetizedConfig,
    steps: int,
    bca_source_wall: bca_mod.BCAInterface,
    bca_wall_wall: bca_mod.BCAInterface,
    *,
    source_species_idx: int = 0,
    wall_species_idx: int = 1,
    product_p2c: Optional[float] = None,
    num_histories: int = 100,
    checkpoint_manager: Optional[ckpt_mod.CheckpointManager] = None,
    seed: int = 0,
    log_every: int = 0,
    pic_steps_per_bca: int = 1,
    write_particles: Optional[str] = None,
    step_fn=None,
):
    """Run the hybrid loop for ``steps`` steps (cfg.impact_buffer_size > 0:
    the wall-impact rows feed the surface model).

    ``write_particles`` (a directory) streams the reference's per-event
    .dat files (pygcpic.py:1440-1447, 1516-1541): one vx/vth line per wall
    impact into ``source_wall.dat`` / ``wall_wall.dat`` (by incident
    species), ``lateral_displacements.dat`` with the wall species'
    sqrt(y^2 + z^2), one vx/vth line per mid-domain escape into
    ``source_out.dat`` / ``wall_out.dat`` (cfg.bca_escape), and the
    products' launch vx/vth into ``{source,wall}_from_wall.dat``.

    ``pic_steps_per_bca`` runs k engine steps per host round trip and the
    surface model once on the block's impact rows; products enter at the
    block's end, so at k > 1 they re-enter up to k - 1 steps later than
    the reference's cadence (k = 1, pygcpic.py:1571-1572).

    ``step_fn``: an optional prebuilt engine step (as
    ``run_bca_from_iead``'s); ``magnetized.make_step(cfg)`` by default.

    Returns:
        (final_state, BCAStats, metrics_list): the per-step StepMetrics as
        host numpy arrays.
    """
    if cfg.impact_buffer_size <= 0:
        raise ValueError("cfg.impact_buffer_size must be > 0 for BCA runs")
    if pic_steps_per_bca < 1:
        raise ValueError("pic_steps_per_bca must be >= 1")
    step = magnetized.make_step(cfg) if step_fn is None else step_fn
    inject = magnetized.make_inject(cfg)
    rng = np.random.default_rng(seed)
    stats = BCAStats()
    if product_p2c is None:
        product_p2c = float(state.p2c[0])
    z_to_idx: Dict[int, int] = {z: i for i, z in enumerate(cfg.species_z)}
    metrics_hist = []

    done = 0
    while done < steps:
        k_steps = min(pic_steps_per_bca, steps - done)
        state, ms = run_steps(step, state, k_steps)
        ms = fetch(ms)  # leaves stacked (k_steps, ...), host numpy
        it = done + k_steps - 1
        done += k_steps
        metrics_hist.extend(_row(ms, i) for i in range(k_steps))
        # the valid impact rows of every step of the block
        # (pygcpic.py:1516-1527)
        impacts = np.concatenate([ms.impacts[i, :int(ms.n_impacts[i])]
                                  for i in range(k_steps)])
        src_hit = impacts[:, 2].astype(int) == source_species_idx
        wall_hit = impacts[:, 2].astype(int) == wall_species_idx
        if write_particles is not None:
            esc = np.concatenate([ms.escapes[i, :int(ms.n_escape_rows[i])]
                                  for i in range(k_steps)])
            _append_events(write_particles, "source_wall.dat",
                           impacts[src_hit, 4])
            _append_events(write_particles, "wall_wall.dat",
                           impacts[wall_hit, 4])
            _append_events(write_particles, "lateral_displacements.dat",
                           impacts[wall_hit, 5])
            _append_events(write_particles, "source_out.dat",
                           esc[esc[:, 1].astype(int) == source_species_idx, 0])
            _append_events(write_particles, "wall_out.dat",
                           esc[esc[:, 1].astype(int) == wall_species_idx, 0])
            stats.redeposited += int(impacts[wall_hit, 6].sum())
            # escapes past the per-step row cap lose their event line
            # (never their dynamics): count what the .dat files miss
            stats.escape_lines_dropped += max(
                0, int(np.asarray(ms.n_escaped).sum()) - esc.shape[0])
        stats.source_incident += int(src_hit.sum())
        stats.wall_incident += int(wall_hit.sum())
        new_rows, new_sides = _surface(
            [("source", impacts[src_hit, 0], impacts[src_hit, 1],
              bca_source_wall),
             ("wall", impacts[wall_hit, 0], impacts[wall_hit, 1],
              bca_wall_wall)], stats, rng, num_histories)
        if new_rows:
            state = _inject_products(
                state, inject, new_rows, new_sides, stats, cfg, rng,
                product_p2c, z_to_idx, wall_species_idx, (it + 1) * cfg.dt,
                events=write_particles, source_species_idx=source_species_idx)
        if checkpoint_manager is not None:
            checkpoint_manager.maybe_save(state, done)
        if log_every and (it % log_every < k_steps):
            print(f"step {it}: active {int(ms.n_active[-1])}, impacts "
                  f"{impacts.shape[0]}, yield {stats.total_yield():.3f}, "
                  f"{cfg_species_name(cfg, source_species_idx)} reflection "
                  f"{stats.source_reflection():.3f}")
    return state, stats, metrics_hist


def cfg_species_name(cfg, idx):
    return f"Z={cfg.species_z[idx]}"


def _append_events(dirpath: str, name: str, values) -> None:
    """Append one line per value to a write_particles .dat stream
    (pygcpic.py print(..., file=f, flush=True) format)."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, name), "a") as f:
        f.writelines(f"{v}\n" for v in np.asarray(values))


def run_bca_from_iead(
    state: magnetized.MagnetizedState,
    cfg: magnetized.MagnetizedConfig,
    steps: int,
    bca_source_wall: bca_mod.BCAInterface,
    bca_wall_wall: bca_mod.BCAInterface,
    *,
    source_species_idx: int = 0,
    wall_species_idx: int = 1,
    product_p2c: Optional[float] = None,
    num_histories: int = 100,
    checkpoint_manager: Optional[ckpt_mod.CheckpointManager] = None,
    seed: int = 0,
    log_every: int = 0,
    pic_steps_per_bca: int = 1,
    step_fn=None,
    reshard=None,
    mesh=None,
):
    """The hybrid loop on the histogram channel: each block feeds the
    increment of the in-state per-species IEAD histograms through the
    surface model's ``run_from_iead`` (the reference's
    ``run_tridyn_simulations_from_iead``, pygcpic.py:1299-1300) and
    injects the products into free slots. Impacts are rebuilt at the bin
    centres, and impacts outside [0, iead_energy_max] x [0,
    iead_angle_max] are not seen (np.histogram2d's range,
    pygcpic.py:1259), as in the reference's histogram path.

    The device histogram is drained into a float64 host total every
    round (a float32 bin stops counting at 2^24); the checkpointed and
    returned states carry the running total.

    Args:
        step_fn: optional prebuilt step; ``magnetized.make_step(cfg)`` by
            default (the tests pass the port's step fed the JAX draws, or
            the data-parallel step of ``parallel.make_data_parallel_step``).
        reshard: under data parallel, the cut of a whole state into this
            rank's block (``lambda s: dataparallel.shard_state(s, mesh)``,
            the default with ``mesh``). The IEAD histograms are summed over
            the ranks, so every rank feeds the surface model the global
            wall flux and draws the same products; they are injected into
            the whole state (``dataparallel.gather_state``), in the global
            slot order of one device, which ``reshard`` cuts again.
        mesh: the data-parallel mesh of ``step_fn`` (None: one device).

    Returns:
        (final_state, BCAStats, metrics_list) like ``run_bca``.
    """
    if reshard is not None and mesh is None:
        raise ValueError("reshard cuts the whole state for a data-parallel "
                         "step: pass its mesh too")
    if mesh is not None and reshard is None:
        reshard = lambda s: dataparallel.shard_state(s, mesh)  # noqa: E731
    if cfg.iead_energy_max <= 0.0:
        raise ValueError(
            "cfg.iead_energy_max must be > 0 (IEAD accumulation drives the "
            "histogram channel)")
    if pic_steps_per_bca < 1:
        raise ValueError("pic_steps_per_bca must be >= 1")
    step = magnetized.make_step(cfg) if step_fn is None else step_fn
    inject = magnetized.make_inject(cfg)
    rng = np.random.default_rng(seed)
    stats = BCAStats()
    if product_p2c is None:
        product_p2c = float(state.p2c[0])
    z_to_idx: Dict[int, int] = {z: i for i, z in enumerate(cfg.species_z)}
    metrics_hist = []

    ne, na = cfg.iead_bins
    edges = (np.linspace(0.0, cfg.iead_energy_max, ne + 1),
             np.linspace(0.0, cfg.iead_angle_max, na + 1))
    iead_total = state.iead.double().cpu().numpy().copy()

    def _with_total(st):
        return st.replace(iead=torch.from_numpy(iead_total).to(
            st.iead.device, st.iead.dtype))

    state = state.replace(iead=torch.zeros_like(state.iead))
    done = 0
    while done < steps:
        k_steps = min(pic_steps_per_bca, steps - done)
        state, ms = run_steps(step, state, k_steps)
        ms = fetch(ms)
        it = done + k_steps - 1
        done += k_steps
        metrics_hist.extend(_row(ms, i) for i in range(k_steps))
        delta = state.iead.double().cpu().numpy()
        iead_total += delta
        state = state.replace(iead=torch.zeros_like(state.iead))
        channels = [("source", delta[source_species_idx], bca_source_wall),
                    ("wall", delta[wall_species_idx], bca_wall_wall)]
        stats.source_incident += int(round(channels[0][1].sum()))
        stats.wall_incident += int(round(channels[1][1].sum()))
        new_rows, new_sides = _surface(channels, stats, rng, num_histories,
                                       from_iead=edges)
        if new_rows:
            if mesh is not None:
                state = dataparallel.gather_state(state, mesh)
            state = _inject_products(
                state, inject, new_rows, new_sides, stats, cfg, rng,
                product_p2c, z_to_idx, wall_species_idx, (it + 1) * cfg.dt)
            if mesh is not None:
                state = reshard(state)
        if checkpoint_manager is not None:
            # checkpoints carry the running total (resume re-drains it)
            checkpoint_manager.maybe_save(_with_total(state), done)
        if log_every and (it % log_every < k_steps):
            print(f"step {it}: active {int(ms.n_active[-1])}, yield "
                  f"{stats.total_yield():.3f}, "
                  f"{cfg_species_name(cfg, source_species_idx)} reflection "
                  f"{stats.source_reflection():.3f}")
    return _with_total(state), stats, metrics_hist
