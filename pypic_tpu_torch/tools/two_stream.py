"""bench.py's two-stream cell (BASELINE configs[0]) for the explicit engine.

    python -m pypic_tpu_torch.tools.two_stream [--n N] [--ng NG]
        [--steps S] [--dtype float32|float64]

The configuration of ``bench.py`` ``bench_two_stream`` (bench.py:335-343):
density 1e10 m^-3, Te = Ti = 0.1 eV, L = 15 debye lengths, ng = 200,
perturbation 0.05, Kp 1, dt = 0.1 / wp. ``device_load`` makes the load on
the device from a seeded ``torch.Generator`` with the formulas of
``initialize.initialize_periodic``'s two-stream branch (the same
distribution, other numbers): loading 1e8 particles through numpy would
spend most of a run on the host.

``state(..., dtype=torch.float64)`` builds the cell's state in float64:
the float32 load cast before x / dx, so both dtypes start from the same
particles. Run as a script it drives the cell on the card (the explicit
engine's fused step; ``--dtype float64`` its double kernels) and prints
one JSON line: ms/step over the timed steps, the total energy change
and the launches.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .. import devices
from ..constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from ..engines import explicit
from ..grid import GridSpec
from ..initialize import TWO_STREAM, PlasmaParams, derive_plasma

NG = 200
DENSITY = 1e10
TE = 0.1 * 11600.0
PERTURBATION = 0.05


def config(n: int, ng: int = NG, **kw):
    """(ExplicitConfig, PlasmaParams) of the cell at n particles."""
    debye = np.sqrt(K_BOLTZMANN * TE * EPSILON_0 / E_CHARGE**2 / DENSITY)
    grid = GridSpec(ng, 15.0 * debye, "periodic")
    params = derive_plasma(TWO_STREAM, n, DENSITY, 1, TE, TE, grid.length)
    return explicit.ExplicitConfig(grid, 0.1 / params.wp, params.p2c, **kw), params


def device_load(n: int, grid: GridSpec, params: PlasmaParams, device,
                seed: int = 2):
    """The two-stream load on ``device``: half the electrons drift at
    -2 vte and half at +2 vte with a spread of vte / 2; positions uniform,
    then about n * 0.05 of them redrawn cell by cell with weights
    1 + cos(K x) (initialize.py ``_cosine_perturbation``). Returns float32
    (x [m], v [m/s])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32
    vte = float(np.sqrt(params.kbte / M_ELECTRON))
    half = n // 2
    v = torch.randn(n, generator=gen, device=device, dtype=f32) * (0.5 * vte)
    v[:half] -= 2.0 * vte
    v[half:] += 2.0 * vte
    x = torch.rand(n, generator=gen, device=device, dtype=f32) * grid.length
    # per-cell counts on the host (ng values), as the numpy loader has them
    edges = np.linspace(0.0, grid.length, grid.ng + 1)
    f = 1.0 + np.cos(params.k * edges)
    counts = ((n * PERTURBATION) * f / np.sum(f))[:grid.ng].astype(int)
    total = min(int(counts.sum()), n)
    cells = torch.repeat_interleave(
        torch.arange(grid.ng, device=device),
        torch.from_numpy(counts).to(device))[:total]
    lo = torch.from_numpy(edges[:-1]).to(device=device, dtype=f32)[cells]
    x[:total] = lo + torch.rand(total, generator=gen, device=device,
                                dtype=f32) * np.float32(grid.dx)
    return x, v


def state(n: int, device=None, ng: int = NG, seed: int = 2,
          dtype: torch.dtype = torch.float32, **kw):
    """(cfg, params, initial ExplicitState) of the cell on ``device`` (the
    current CUDA device by default), in ``dtype`` (float64: the float32
    load cast before x / dx)."""
    device = devices.resolve(device)
    cfg, params = config(n, ng, **kw)
    x, v = device_load(n, cfg.grid, params, device, seed)
    st = explicit.init_state(x.to(dtype), v.to(dtype), -E_CHARGE, M_ELECTRON, cfg,
                             dtype=dtype, device=device)
    return cfg, params, st


def run_cell(device, n: int, ng: int = NG, steps: int = 20, warmup: int = 2,
             dtype: torch.dtype = torch.float32) -> dict:
    """The cell through ``runner.run``: ``warmup`` steps, then ``steps``
    timed ones. Returns ms/step, the total energy change over all the
    steps' pre-push energies, and the launches counted from 0 before the
    state was built."""
    from ..ops import cuda_cic
    from ..runner import run

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    cuda_cic.reset_launch_counts()
    cfg, _, st = state(n, device, ng, dtype=dtype)
    step = explicit.make_step(cfg)
    st, wm = run(step, st, warmup)
    sync()
    t0 = time.perf_counter()
    st, m = run(step, st, steps)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    tot = (torch.cat([wm.field_energy, m.field_energy])
           + torch.cat([wm.kinetic_energy, m.kinetic_energy])).double().cpu()
    return dict(n=n, ng=ng, dtype=str(dtype).replace("torch.", ""), steps=steps,
                ms_per_step=ms, total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]),
                state_dtype=str(st.p.dtype).replace("torch.", ""),
                launches={k: v for k, v in cuda_cic.LAUNCHES.items() if v})


def parser():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_007_936)
    ap.add_argument("--ng", type=int, default=NG)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                    help="the state's dtype (float64: the double kernels)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    res = run_cell(torch.device("cuda", 0), args.n, args.ng, args.steps,
                   dtype=getattr(torch, args.dtype))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
