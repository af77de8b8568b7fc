"""bench.py's Landau-damping row (BASELINE configs[1]) on one GPU.

The configuration of ``bench.py`` ``bench_landau`` (bench.py:388-438) and
``_landau_problem`` (bench.py:209-247) with bench's default options: the
reference Landau preset (pypic.py:846-855: ng 200, L 22 debye lengths,
density 1e5 m^-3, Te 100 eV, dt 1e-5) at n = 100,000, tol 1e-6,
maxiter 50, picard_init 'field', picard_accel 'none', finalize
'converged', finalize_field 'last', window_share 'auto'; the device-side
load of ``tools/headline.py`` (bench.py's distribution, other numbers).
The row runs 16,000 steps through ``implicit.run_resident``, 64 a launch.

    python -m pypic_tpu_torch.tools.landau

runs it and prints one JSON line: µs/step, pushes/s, the mean Picard
iteration count and the total energy change over the run. It needs an
NVIDIA GPU.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .. import devices
from ..constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from ..engines import implicit
from ..grid import GridSpec
from .headline import device_load

N = 100_000
NG = 200
STEPS = 16_000
STEPS_PER_CALL = 64
TOL = 1e-6
MAXITER = 50
DENSITY, TE, DT = 1e5, 100.0 * 11600.0, 1e-5


def config(n: int = N) -> implicit.ImplicitConfig:
    """``_landau_problem(n, 1e-6)``'s configuration with bench's defaults."""
    debye = np.sqrt(K_BOLTZMANN * TE * EPSILON_0 / E_CHARGE**2 / DENSITY)
    length = 22.0 * debye
    return implicit.ImplicitConfig(
        GridSpec(NG, length, "periodic"), DT, length * DENSITY / n, tol=TOL,
        maxiter=MAXITER, picard_init="field", finalize="converged",
        picard_accel="none", finalize_field="last", window_share="auto")


def state(n: int = N, device=None):
    """(cfg, initial ImplicitState) of the row on ``device`` (the current
    CUDA device by default), from device_load's default seed."""
    device = devices.resolve(device)
    cfg = config(n)
    x, v = device_load(n, cfg.grid.length, device)
    return cfg, implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg,
                                    device=device)


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    cfg, st = state(N, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = implicit.run_resident(cfg, st, STEPS, steps_per_call=STEPS_PER_CALL)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tot = (m.field_energy.double() + m.kinetic_energy.double()).cpu()
    res = dict(device=torch.cuda.get_device_name(0), n=N, steps=STEPS,
               steps_per_call=STEPS_PER_CALL, us_per_step=seconds * 1e6 / STEPS,
               pushes_per_s=N * STEPS / seconds,
               picard_mean=float(m.picard_iters.float().mean()),
               total_energy_rel_change=float((tot[-1] - tot[0]) / tot[0]))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
