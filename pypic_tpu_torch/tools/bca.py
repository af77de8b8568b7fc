"""The pic_bca_aps path on one GPU: the reference's hybrid PIC <-> surface
model driver (pygcpic.py:1307-1344, 1500-1632) at its published size.

``presets.pic_bca_aps`` at ppc 200 (ng 600, n = 120,000 in 180,000
slots; dt 8e-11, Ti 10 eV, Te 50 eV, B = 2 T at 86 degrees, smooth_rho,
ionization, 'capped-source' re-activation, the BCA escape, 1,024 impact
rows a step) runs through ``engines.bca_driver.run_bca`` with the
F-TRIDYN stand-in ``bca.BinaryCollisionModel`` (H -> B seed 1, B -> B
seed 2, as tests/test_bca.py:112-117). 'auto' takes the fused backend,
the Newton kernel and the full-capacity Philox source batch on the card.

    python -m pypic_tpu_torch.tools.bca [--steps 200] [--per-bca 1]

prints one JSON line: the whole block's ms/step (the engine, the
device-to-host copy of the block's metrics, the surface model in numpy,
the injection and its read of the injected and dropped counts), the
engine's ms/step alone (the same steps through
``runner.run``, no surface model), the surface model's share of the
block's wall time, the BCAStats, the ionization and escape counts summed
and the Newton iterations; it exits non-zero when a check of
tests/test_bca.py:148-165 fails. Every engine step runs under
``torch.cuda.set_sync_debug_mode("error")`` (a host sync in a step
raises); the block's two host reads and the injection are outside it. It
needs an NVIDIA GPU.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from .. import bca, devices, presets
from ..constants import M_PROTON
from ..engines import bca_driver, magnetized
from ..ops import _build, cuda_cic
from ..runner import run

PPC = 200
STEPS = 200
WARMUP = 2
B_AMU = 10.81


class TimedModel:
    """A surface model that adds the wall seconds of its calls to
    ``seconds`` (the driver's host share)."""

    def __init__(self, model):
        self.model = model
        self.seconds = 0.0

    def run(self, energies_ev, angles_deg, num_histories: int = 100):
        t0 = time.perf_counter()
        try:
            return self.model.run(energies_ev, angles_deg, num_histories)
        finally:
            self.seconds += time.perf_counter() - t0


def guarded(step, cuda: bool):
    """``step`` under the sync debug mode "error" on a CUDA device: a host
    sync inside it raises."""
    if not cuda:
        return step

    def run_step(state):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    return run_step


def check(pre, fin, stats) -> list:
    """tests/test_bca.py:148-165's invariants, as a list of problems."""
    problems = []
    act = fin.active == 1
    n_h = int(((fin.species_idx == 0) & act & (fin.charge_state > 0)).sum())
    for ok, what in (
            (stats.source_incident > 100, f"source incidents {stats.source_incident}"),
            (stats.sputtered > 0 and stats.source_reflected > 0,
             f"sputtered {stats.sputtered}, reflected {stats.source_reflected}"),
            (stats.injected > 0, f"injected {stats.injected}"),
            (stats.dropped == 0, f"dropped {stats.dropped}"),
            (int((fin.from_wall[act] == 1).sum()) > 0, "no wall-born particle alive"),
            (int((fin.species_idx[act] == 1).sum()) > 0, "no boron alive"),
            (0.0 < stats.total_yield() < 0.5, f"yield {stats.total_yield()}"),
            (n_h == pre.meta["source_n"],
             f"ionized H population {n_h} != source_n {pre.meta['source_n']}")):
        if not ok:
            problems.append(what)
    return problems


def seeded_state(pre, count: int = 256, escaping: int = 16, seed: int = 0):
    """The preset's state with ``count`` neutral wall-born B rows planted in
    its last free slots (from_wall 1, 10.81 amu, charge 0, a thousandth of
    the plasma's p2c: an ionization probability of 0.1-1 a step, where
    the plasma's weight gives ~1e-4), spread over the domain at thermal
    speeds of a few eV, ``escaping`` of them slow in the escape band
    length/2 +/- length/8 (pygcpic.py:1529-1541): a state on which the
    ionization and the escape both fire in the first step."""
    st = pre.state
    cells = pre.config.grid.num_cells
    free = torch.nonzero(st.active != 1).flatten()[-count:]
    gen = torch.Generator().manual_seed(seed)
    dev = st.p.device

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    pos = (0.05 + 0.9 * rand(count)) * cells
    pos[:escaping] = cells / 2 + (2 * rand(escaping) - 1) * cells / 16
    vel = torch.randn(3, count, generator=gen).to(dev) * 3e3
    vel[:, :escaping] = 1.0
    fields = dict(p=pos, vx=vel[0], vy=vel[1], vz=vel[2])
    out = {k: getattr(st, k).clone() for k in (
        "p", "vx", "vy", "vz", "m", "charge_state", "p2c", "species_idx",
        "active", "from_wall")}
    for k, v in fields.items():
        out[k][free] = v.to(out[k].dtype)
    out["m"][free] = B_AMU * M_PROTON
    out["charge_state"][free] = 0.0
    out["p2c"][free] = float(st.p2c[0]) * 1e-3
    out["species_idx"][free] = 1
    out["active"][free] = 1
    out["from_wall"][free] = 1
    return st.replace(**out)


def run_path(device=None, steps: int = STEPS, per_bca: int = 1):
    """Run the path: the preset at ppc 200 on ``device``, WARMUP engine
    steps (set-up: the first launch of each kernel loads it), then
    ``steps`` engine steps alone and ``steps`` steps of ``run_bca`` in
    blocks of ``per_bca``, each from the initial state, the launch counts
    set to 0 before the driver's run. Returns (result dict, preset, final
    state, BCAStats, metrics list)."""
    dev = devices.resolve(device)
    cuda = dev.type == "cuda"
    pre = presets.pic_bca_aps(ppc=PPC, device=dev)
    cfg = pre.config
    if cuda:
        _build.load()  # the build is set-up
    step = guarded(magnetized.make_step(cfg), cuda)
    run(step, pre.state, WARMUP)

    def timed(fn):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    (_, m_engine), engine_s = timed(lambda: run(step, pre.state, steps))
    models = (TimedModel(bca.BinaryCollisionModel(seed=1)),
              TimedModel(bca.BinaryCollisionModel(incident_m_amu=B_AMU,
                                                  incident_z=5, seed=2)))
    cuda_cic.reset_launch_counts()
    (fin, stats, hist), block_s = timed(lambda: bca_driver.run_bca(
        pre.state, cfg, steps, *models, seed=3, pic_steps_per_bca=per_bca,
        step_fn=step))
    surface_s = sum(mdl.seconds for mdl in models)
    res = dict(
        device=torch.cuda.get_device_name(dev) if cuda else "cpu",
        n=pre.meta["source_n"], capacity=pre.state.p.shape[0], ng=cfg.grid.ng,
        steps=steps, pic_steps_per_bca=per_bca,
        block_ms_per_step=block_s * 1e3 / steps,
        engine_ms_per_step=engine_s * 1e3 / steps,
        surface_model_share=surface_s / block_s,
        surface_model_ms_per_step=surface_s * 1e3 / steps,
        stats=dataclasses.asdict(stats),
        total_yield=stats.total_yield(),
        n_ionized=int(sum(int(m.n_ionized) for m in hist)),
        n_escaped=int(sum(int(m.n_escaped) for m in hist)),
        n_reactivated=int(sum(int(m.n_reactivated) for m in hist)),
        newton_mean=float(m_engine.newton_iters.float().mean()),
        newton_max=int(m_engine.newton_iters.max()),
        launches={k: v for k, v in cuda_cic.LAUNCHES.items() if v})
    return res, pre, fin, stats, hist


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--per-bca", type=int, default=1,
                    help="pic_steps_per_bca: engine steps a surface-model call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    res, pre, fin, stats, _ = run_path(torch.device("cuda", 0), steps=args.steps,
                                       per_bca=args.per_bca)
    res["problems"] = check(pre, fin, stats)
    print(json.dumps(res))
    if res["problems"]:
        raise SystemExit(f"pic_bca_aps path failed: {res['problems']}")
    return res


if __name__ == "__main__":
    main()
