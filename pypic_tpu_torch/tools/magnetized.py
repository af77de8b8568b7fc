"""bench.py's magnetized row (BASELINE configs[3]) on one GPU.

The configuration of ``bench.py`` ``bench_magnetized`` (bench.py:478-546)
with bench's default options: the reference ``pic_iead`` preset
(pygcpic.py:1120-1200: D+ and B 1+..5+, ng 600, B = 2 T at 86 degrees,
dt 1e-10, Boltzmann electrons, Dirichlet-Dirichlet walls, IEAD collection,
re-activation from the volumetric source) at n_per_species = 166,666,
n = 999,996, and the engine's defaults (newton_tol 1e-9, newton_maxiter
1000, warm start 'previous', the reference's gather weights and
re-activation timing, react_batch 0). 'auto' takes the fused backend, the
one-launch Newton kernel and the Philox source kernel on the card. The row
runs 1,200 steps through ``runner.run``, bench's n and steps.

    python -m pypic_tpu_torch.tools.magnetized

runs it and prints one JSON line: µs/step, pushes/s, the mean Newton
iteration count, the mean phi_max of the last 100 steps over the floating
potential, and the kernel launches. It needs an NVIDIA GPU. The steps run
under ``torch.cuda.set_sync_debug_mode("error")``: a host sync in a step
raises.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from .. import devices, presets
from ..engines import magnetized
from ..ops import _build, cuda_cic
from ..runner import run

N_PER_SPECIES = 166_666
N = 6 * N_PER_SPECIES
STEPS = 1200


def state(device=None, n_per_species: int = N_PER_SPECIES):
    """(cfg, initial MagnetizedState, floating potential [V]) of the row on
    ``device`` (the current CUDA device by default)."""
    pre = presets.pic_iead(n_per_species=n_per_species,
                           device=devices.resolve(device))
    return pre.config, pre.state, pre.meta["floating_potential"]


def check_row(cfg, fin, m) -> list:
    """The row's physics checks, as a list of problems: the source keeps
    the population (n_active + this step's wall losses constant, each
    step's re-activations equal the previous step's losses:
    tests/test_magnetized.py:341-353), the Newton residual <= tol after
    step 5, finite fields, and both species' IEADs non-empty."""
    problems = []
    n_act = m.n_active.cpu().numpy()
    hits = m.n_hit_wall.cpu().numpy()
    tot = n_act + hits
    if not (tot == tot[0]).all():
        problems.append(f"population not kept: n_active + hits in "
                        f"[{tot.min()}, {tot.max()}]")
    if not np.array_equal(m.n_reactivated.cpu().numpy()[1:], hits[:-1]):
        problems.append("re-activations differ from the previous step's losses")
    resid = m.newton_residual[5:].cpu().numpy()
    if not (resid <= np.float32(cfg.newton_tol)).all():
        problems.append(f"Newton residual above tol after step 5: max {resid.max()}")
    if not (torch.isfinite(m.phi).all() and torch.isfinite(fin.p).all()):
        problems.append("non-finite phi or positions")
    per_species = fin.iead.sum(dim=(1, 2)).cpu()
    if not bool((per_species > 0).all()):
        problems.append(f"empty IEAD: {per_species.tolist()}")
    return problems


def run_row(device=None, steps: int = STEPS,
            n_per_species: int = N_PER_SPECIES, warmup: int = 3, **overrides):
    """Run the row: ``warmup`` steps from the initial state (set-up: the
    first launch of each PyTorch kernel loads it), then from the initial
    state again, the launch counts set to 0, ``steps`` steps under the
    sync debug mode "error" and one synchronize. ``overrides`` replace config
    fields (e.g. backend='composed'). On a CPU device (the plain versions;
    no timing meaning) there is no sync to watch. Returns (result dict,
    config, final state, stacked StepMetrics)."""
    import dataclasses

    dev = devices.resolve(device)
    cuda = dev.type == "cuda"
    cfg, st, phi_f = state(dev, n_per_species)
    cfg = dataclasses.replace(cfg, **overrides)
    step = magnetized.make_step(cfg)
    if cuda:
        _build.load()  # the build is set-up, not step time
    if warmup:
        run(step, st, warmup)
    if cuda:
        torch.cuda.synchronize(dev)
    cuda_cic.reset_launch_counts()
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        fin, m = run(step, st, steps)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    n = st.p.shape[0]
    last = min(100, steps)
    res = dict(device=torch.cuda.get_device_name(dev) if cuda else "cpu",
               n=n, steps=steps,
               us_per_step=seconds * 1e6 / steps,
               pushes_per_s=n * steps / seconds,
               newton_mean=float(m.newton_iters.float().mean()),
               phi_max_over_phi_f=float(m.phi_max[-last:].double().mean()) / phi_f,
               launches={k: v for k, v in cuda_cic.LAUNCHES.items() if v})
    return res, cfg, fin, m


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    res, cfg, fin, m = run_row(torch.device("cuda", 0))
    res["problems"] = check_row(cfg, fin, m)
    print(json.dumps(res))
    if res["problems"]:
        raise SystemExit(f"configs[3] row failed: {res['problems']}")
    return res


if __name__ == "__main__":
    main()
