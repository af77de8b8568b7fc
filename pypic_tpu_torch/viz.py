"""Offline visualization: summary figures, png sequences, gif assembly,
phase-space replay (the port's own copy of ``pypic_tpu/viz.py``: the same
eight functions with the same signatures).

Rebuilds the reference's L8 plotting as a post-process over saved metric
arrays (the reference draws live matplotlib inside the time loop,
pypic.py:579-634 — here the hot loop stays compiled and plotting consumes the
stacked metrics afterwards):

* ``summary_figure``: the gen-3 2x2 summary panel — phase-space density,
  velocity distribution, E^2 history with the analytic-rate overlay, E/J
  profiles (pypic.py:580-631).
* ``sheath_figure``: the gen-2 panels — per-species phase space in
  signed-energy units, potential, field, current (PIC_L_DD.py:554-624).
* ``iead_figure``: per-species ion energy-angle heatmaps — pic_iead's live
  pcolormesh figures (pygcpic.py:1283-1298) as one offline panel.
* ``bca_figure``: the pic_bca_aps 8-figure run dashboard (pygcpic.py:
  1634-1702) — wall-folded + zoomed phase space, phi/rho profiles,
  incident and flux-out IEADs per species.
* ``save_frames`` + ``convert``: png sequence + animated gif assembly at the
  reference's 0.2 s/frame (convert.py:4-12).
* ``phase_space_replay``: offline animation of dumped particle positions,
  colored by |v| — the vpython replay equivalent (pypic_vpython.py:20-61)
  rendered headlessly with matplotlib.

matplotlib uses the Agg backend; nothing here imports in the engines.
Every function takes numpy arrays (host copies): the CLI moves the run's
tensors to the host once, at its end.
"""

from __future__ import annotations

import os

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def summary_figure(path, x, v, vth, energy, times, wp, growth_rate, e_field,
                   current, length, vmax=8.0, system=""):
    """Gen-3 2x2 summary (pypic.py:580-631)."""
    fig, ax = plt.subplots(2, 2, figsize=(12, 7))
    vn = np.asarray(v) / vth
    ax[0, 0].hist2d(np.asarray(x), vn, bins=(100, 50),
                    range=[[0.0, length], [-vmax, vmax]])
    ax[0, 0].set_title("Phase Space Density")
    ax[0, 0].set_xlabel("x [m]")
    ax[0, 0].set_ylabel("v [thermal]")

    ax[0, 1].hist(vn, bins=200, orientation="horizontal", density=True,
                  histtype="stepfilled", color="grey")
    ax[0, 1].set_ylim([-vmax, vmax])
    ax[0, 1].set_title("Total Distribution Function")

    tt = np.asarray(times)
    ee = np.asarray(energy)
    ax[1, 1].semilogy(tt * wp, ee, lw=2, label="E2")
    if growth_rate is not None and len(ee) > 2:
        ref = ee.min() * np.exp(2.0 * growth_rate * (tt - tt[0]))
        ax[1, 1].semilogy(tt * wp, ref, lw=2, label="Theoretical")
    ax[1, 1].legend()
    ax[1, 1].set_title("Total Electrostatic Energy")
    ax[1, 1].set_xlabel("t [1/wp]")

    xs = np.linspace(0.0, length, len(np.asarray(e_field)))
    e = np.asarray(e_field)
    j = np.asarray(current)
    ax[1, 0].plot(xs, 0.6 * e / (np.abs(e).max() + 1e-300), lw=2, label="E")
    ax[1, 0].plot(xs, 0.6 * j / (np.abs(j).max() + 1e-300), lw=2, label="J")
    ax[1, 0].set_ylim([-1, 1])
    ax[1, 0].legend()
    ax[1, 0].set_xlabel("x [m]")
    fig.suptitle(system)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def sheath_figure(path, x, v_x, m, species, phi, e_field, current, length):
    """Gen-2 sheath panels (PIC_L_DD.py:554-624): per-species phase space in
    signed kinetic-energy units [eV], potential, field, current."""
    from .constants import E_CHARGE

    fig, ax = plt.subplots(2, 2, figsize=(12, 7))
    x = np.asarray(x)
    u = np.asarray(v_x)
    m = np.asarray(m)
    sp = np.asarray(species)
    energy_signed = np.sign(u) * 0.5 * m * u * u / E_CHARGE
    for s, (r, title) in {1: (0, "Electron Phase Space"),
                          2: (1, "Ion Phase Space")}.items():
        sel = sp == s
        ax[0, r].scatter(x[sel], energy_signed[sel], s=0.5)
        ax[0, r].set_title(title)
        ax[0, r].set_xlim([0, length])
        ax[0, r].set_xlabel("x [m]")
        ax[0, r].set_ylabel("sgn(v) E [eV]")
    xs = np.linspace(0.0, length, len(np.asarray(phi)))
    ax[1, 0].plot(xs, np.asarray(phi), lw=2)
    ax[1, 0].set_title("potential")
    ax[1, 1].plot(xs, np.asarray(e_field), lw=2, label="E")
    ax2 = ax[1, 1].twinx()
    ax2.plot(xs, np.asarray(current), lw=1, color="k", label="J")
    ax[1, 1].set_title("E / J")
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def iead_figure(path, iead, energy_max, angle_max, species_labels=None):
    """Per-species ion energy-angle distribution heatmaps — the offline
    equivalent of pic_iead's live pcolormesh figures (pygcpic.py:1283-1298:
    ``pcolormesh(angle_range, energy_range, iead.T)``, saved as iead_D /
    iead_B).

    Args:
        iead: (S, ne, na) accumulated histograms (MagnetizedState.iead).
        energy_max / angle_max: histogram ranges (MagnetizedConfig); axes
            span [0, energy_max] eV x [0, angle_max] degrees.
        species_labels: S display names (default S0, S1, ...).
    """
    iead = np.asarray(iead)
    s, ne, na = iead.shape
    labels = species_labels or [f"S{i}" for i in range(s)]
    fig, axes = plt.subplots(1, s, figsize=(5.5 * s, 4.5), squeeze=False)
    energies = np.linspace(0.0, energy_max, ne + 1)
    angles = np.linspace(0.0, angle_max, na + 1)
    for i, ax in enumerate(axes[0]):
        pm = ax.pcolormesh(angles, energies, iead[i])
        fig.colorbar(pm, ax=ax)
        ax.set_title(f"{labels[i]} IEAD (n={iead[i].sum():.0f})")
        ax.set_xlabel("angle [deg]")
        ax.set_ylabel("energy [eV]")
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def bca_figure(path, x, v_x, vth, phi, rho, iead, iead_out, energy_max,
               angle_max, length, species_labels=None):
    """The pic_bca_aps 8-figure run dashboard as one offline panel
    (pygcpic.py:1634-1702): wall-folded phase space, phi and rho profiles,
    per-species incident IEADs, per-species sheath-escape ("flux out")
    IEADs, and the zoomed near-wall phase space.

    Args:
        x: (n,) particle positions [m] (active rows).
        v_x: (n,) x velocities [m/s].
        vth: thermal-speed normalization for the phase-space axes.
        phi / rho: (ng,) grid profiles.
        iead / iead_out: (S, ne, na) incident / escape histograms
            (MagnetizedState.iead / .iead_out).
        length: domain length [m].
    """
    iead = np.asarray(iead)
    iead_out = np.asarray(iead_out)
    s, ne, na = iead.shape
    labels = species_labels or [f"S{i}" for i in range(s)]
    x = np.asarray(x)
    vn = np.asarray(v_x) / (vth + 1e-300)
    # fold about the midplane: both sheaths overlay (pygcpic.py:1638-1639)
    vf = np.where(x < length / 2.0, vn, -vn)
    xf = np.where(x < length / 2.0, x, length - x)

    ncol = max(2 + s, 4)
    fig, ax = plt.subplots(2, ncol, figsize=(4.5 * ncol, 8), squeeze=False)
    ax[0, 0].scatter(xf, vf, s=0.5)
    ax[0, 0].set_xlim([0.0, length / 4.0])
    ax[0, 0].set_ylim([-8.0, 8.0])
    ax[0, 0].set_title("Phase Space (wall-folded)")
    ax[0, 0].set_xlabel("x [m]")
    ax[0, 0].set_ylabel("v [thermal]")

    ax[1, 0].scatter(xf, vf, s=0.5)
    ax[1, 0].set_xlim([0.0, length / 8.0])
    ax[1, 0].set_ylim([-6.0, 6.0])
    ax[1, 0].set_title("Phase Space (zoomed)")
    ax[1, 0].set_xlabel("x [m]")

    xs = np.linspace(0.0, length, len(np.asarray(phi)))
    ax[0, 1].plot(xs, np.asarray(phi), lw=2)
    ax[0, 1].set_xlim([0.0, length])
    ax[0, 1].set_title("phi [V]")
    ax[1, 1].plot(xs, np.asarray(rho), lw=2)
    ax[1, 1].set_xlim([0.0, length])
    ax[1, 1].set_title("rho [C/m^3]")

    energies = np.linspace(0.0, energy_max, ne + 1)
    angles = np.linspace(0.0, angle_max, na + 1)
    for i in range(s):
        col = 2 + i
        pm = ax[0, col].pcolormesh(angles, energies, iead[i])
        fig.colorbar(pm, ax=ax[0, col])
        ax[0, col].set_title(f"{labels[i]} IEAD")
        pm = ax[1, col].pcolormesh(angles, energies, iead_out[i])
        fig.colorbar(pm, ax=ax[1, col])
        ax[1, col].set_title(f"{labels[i]} Flux Out")
        ax[1, col].set_xlabel("angle [deg]")
    for i in range(2 + s, ncol):
        ax[0, i].axis("off")
        ax[1, i].axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def save_frames(directory, prefix, frames_fn, indices):
    """Write a png frame per index via frames_fn(index, path)."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i in indices:
        p = os.path.join(directory, f"{prefix}_{i}.png")
        frames_fn(i, p)
        paths.append(p)
    return paths


def convert(directory, prefix, start, stop, skip, outname,
            duration: float = 0.2):
    """png sequence -> animated gif (convert.py:4-12 parity: frames
    ``{directory}/{prefix}_{i}.png`` for i in range(start, stop, skip))."""
    import imageio.v2 as imageio

    images = [
        imageio.imread(os.path.join(directory, f"{prefix}_{i}.png"))
        for i in range(start, stop, skip)
        if os.path.exists(os.path.join(directory, f"{prefix}_{i}.png"))
    ]
    if not images:
        raise FileNotFoundError(f"no frames {prefix}_*.png in {directory}")
    imageio.mimsave(outname, images, duration=duration)
    return outname


def load_particle_dump(path, particles_per_frame: int):
    """Load a comma-delimited (x, v) particle dump (the CLI's
    ``--dump-particles`` output; format of pypic_vpython.py:14
    ``np.genfromtxt('particle_output.txt', delimiter=",")``) into per-frame
    (xs, vs) arrays for ``phase_space_replay`` (frame chunking as
    pypic_vpython.py:26-31)."""
    data = np.genfromtxt(path, delimiter=",")
    data = data.reshape(-1, particles_per_frame, 2)
    return data[:, :, 0], data[:, :, 1]


def phase_space_replay(outname, xs, vs, skip: int = 1, max_particles: int = 5000,
                       duration: float = 0.1):
    """Offline (x, v) phase-space animation of dumped particle data, colored
    by |v| — the vpython replay equivalent (pypic_vpython.py:20-61)."""
    import imageio.v2 as imageio

    xs = np.asarray(xs)
    vs = np.asarray(vs)
    frames = []
    vmax = np.abs(vs).max() + 1e-300
    for t in range(0, xs.shape[0], skip):
        fig, ax = plt.subplots(figsize=(8, 5))
        x = xs[t][:max_particles]
        v = vs[t][:max_particles]
        ax.scatter(x, v, s=1.0, c=np.abs(v) / vmax, cmap="viridis")
        ax.set_xlim([xs.min(), xs.max()])
        ax.set_ylim([-vmax, vmax])
        ax.set_xlabel("x")
        ax.set_ylabel("v")
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy())
        plt.close(fig)
    imageio.mimsave(outname, frames, duration=duration)
    return outname
