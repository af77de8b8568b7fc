"""The headline cell on one GPU, and two measurement drivers for it.

The cell is bench.py's headline problem: the reference Landau preset
(pypic.py:846-855: ng 200, L 22 debye lengths, density 1e5 m^-3, Te 100 eV,
dt 1e-5) at n = 6104 * 16384 particles in the conserving configuration
(tol 1e-30, maxiter 4, extrapolated init, Anderson mixing, converged
finalize). ``chip_smoke.py`` drives it too.

    python -m pypic_tpu_torch.tools.headline drift [--steps 10000] [--chunk 500]
        [--ng 200] [--dtype float32|float64] [--tol T] [--maxiter K]
    python -m pypic_tpu_torch.tools.headline profile --out DIR [--steps 5]
        [--cell landau|two-stream|magnetized|carried|sheath|dn|gc|bca] [--ng 200]
        [--dtype float32|float64] [--window-share auto|shared|separate]

``--ng`` refines the headline cell's grid as the Landau preset does (L
stays 22 Debye lengths; the particle kernels take their large modes above
their shared-memory ceilings, up to ``cuda_cic.LARGE_MAX_NG``); it applies
to ``--cell landau`` only. ``--dtype float64`` runs the cell's state (the
same float32 load, cast) on the double kernels: rows 1-6 for
``landau``, rows 7-9, 22 and 23 for ``magnetized``, ``carried``, ``dn``
and ``gc`` (``tools/magnetized.cast_state``). ``--window-share`` sets the
landau cell's Picard window ('shared': row 2's shared-window pass).

``drift`` steps the cell through ``runner.run`` in chunks and prints, per
chunk, the relative change of the total (field + kinetic) energy since
step 0 and the sustained ms/step; ``--tol`` and ``--maxiter`` replace the
conserving configuration's (tol 1e-30, maxiter 4) to run a tolerance-exit
configuration, and the Picard passes a step are reported. ``profile`` times untraced repeats,
then traces steps with ``torch.profiler`` and reports device time per
step by kernel, the device's idle share and the host syncs per step; it
writes the chrome trace and the profiler's table under ``--out``.
``--cell two-stream`` profiles the explicit engine on bench.py's
two-stream cell (``tools/two_stream.py``) at the same n instead;
``--cell magnetized`` profiles bench.py's configs[3] row
(``tools/magnetized.py``, n = 999,996), ``--cell carried`` the same row as
``bench.py --carried`` runs it (``tools/magnetized.py --carried``: the
carried deposit, the carry primed at set-up) and ``--cell sheath`` its configs[2]
row (``tools/sheath.py``, n = 1,000,000; ``--n`` is ignored for these,
and the sheath profile also reports the Picard passes a step beside the
host syncs); ``--cell dn`` and ``--cell gc`` profile the magnetized
engine's D-N row and guiding-center row (``tools/magnetized.py --row
dn|gc``), and ``--cell bca`` the engine step of the pic_bca_aps path
alone (``presets.pic_bca_aps`` at ppc 200, no surface model:
``tools/bca.py`` times the whole hybrid block). Each reports the device
kernel launches a step and ends with one JSON line of its results.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import time

import numpy as np
import torch

from ..constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from ..engines import implicit
from ..grid import GridSpec
from ..runner import run

NG = 200
N_HEADLINE = 6104 * 16384
CONSERVING = dict(tol=1e-30, maxiter=4, picard_init="extrapolate",
                  picard_accel="anderson", finalize="converged",
                  finalize_field="last", window_share="auto")
_DENSITY, _TE, _DT = 1e5, 100.0 * 11600.0, 1e-5
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def headline_config(n: int, ng: int = NG, **overrides) -> implicit.ImplicitConfig:
    """The reference Landau preset at n particles and ng nodes,
    conserving config (``overrides`` replace its options)."""
    debye = np.sqrt(K_BOLTZMANN * _TE * EPSILON_0 / E_CHARGE**2 / _DENSITY)
    length = 22.0 * debye
    return implicit.ImplicitConfig(GridSpec(ng, length, "periodic"), _DT,
                                   length * _DENSITY / n, **dict(CONSERVING, **overrides))


def device_load(n: int, length: float, device, seed: int = 1):
    """bench.py's device-side load from a seeded torch.Generator: uniform
    x displaced by the cosine perturbation, Maxwellian v (the same
    distribution as bench.py, other numbers). Returns float32 (x, v)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    vth = np.sqrt(2.0 * K_BOLTZMANN * _TE / M_ELECTRON)
    f32 = torch.float32
    x = torch.rand(n, generator=gen, device=device, dtype=f32) * np.float32(length)
    v = torch.randn(n, generator=gen, device=device, dtype=f32) * np.float32(vth / np.sqrt(2.0))
    k_pert = 2.0 * np.pi / length
    x = x + np.float32(0.8 / k_pert) * torch.sin(k_pert * x) * 0.5
    return x, v


def headline_state(n: int, device, seed: int = 1, ng: int = NG,
                   dtype: torch.dtype = torch.float32, **overrides):
    """(cfg, step_fn, initial state) of the cell on ``device``, its state
    in ``dtype`` (float64: the float32 load cast before x / dx, so both
    dtypes start from the same particles)."""
    cfg = headline_config(n, ng, **overrides)
    x, v = device_load(n, cfg.grid.length, device, seed)
    state = implicit.init_state(x.to(dtype), v.to(dtype), -E_CHARGE, M_ELECTRON, cfg,
                                dtype=dtype, device=device)
    return cfg, implicit.make_step(cfg), state


def _total_energy(m) -> torch.Tensor:
    return (m.field_energy.double() + m.kinetic_energy.double()).cpu()


def _overrides(args) -> dict:
    return {k: getattr(args, k) for k in ("tol", "maxiter") if getattr(args, k) is not None}


def drift(args) -> dict:
    dev = torch.device("cuda", 0)
    cfg, step, state = headline_state(args.n, dev, args.seed, args.ng,
                                      DTYPES[args.dtype], **_overrides(args))
    chunks = -(-args.steps // args.chunk)
    e0 = None
    worst, iters_ok, done, seconds, passes = 0.0, True, 0, 0.0, 0
    for _ in range(chunks):
        k = min(args.chunk, args.steps - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run(step, state, k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        seconds += dt
        done += k
        tot = _total_energy(m)
        if e0 is None:
            e0 = float(tot[0])
        rel = (tot - e0) / e0
        worst = max(worst, float(rel.abs().max()))
        iters_ok &= bool((m.picard_iters == cfg.maxiter).all())
        passes += int(m.picard_iters.sum())
        print(f"[drift] step {done}: {float(rel[-1]):+.4e} "
              f"(largest so far {worst:.4e}), {dt * 1e3 / k:.4f} ms/step, "
              f"Picard {float(m.picard_iters.float().mean()):.2f} a step",
              flush=True)
    res = dict(n=args.n, ng=args.ng, seed=args.seed, dtype=args.dtype, tol=cfg.tol,
               maxiter=cfg.maxiter, steps=done, drift=float(rel[-1]),
               largest_excursion=worst, picard_iters_all_max=iters_ok,
               picard_mean=passes / done, ms_per_step=seconds * 1e3 / done)
    print(json.dumps(res))
    return res


def _busy_union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile(args) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = torch.device("cuda", 0)
    if args.cell == "two-stream":
        from ..engines import explicit
        from . import two_stream

        cfg, _, state = two_stream.state(args.n, dev, seed=args.seed)
        step = explicit.make_step(cfg)
    elif args.cell in ("magnetized", "carried"):
        import dataclasses

        from ..engines import magnetized
        from . import magnetized as magnetized_row

        cfg, state, _ = magnetized_row.state(dev)
        state = magnetized_row.cast_state(state, DTYPES[args.dtype])
        if args.cell == "carried":
            cfg = dataclasses.replace(cfg, **magnetized_row.CARRIED)
            state = magnetized.prime_carry(state, cfg)
        args.n = state.p.shape[0]
        step = magnetized.make_step(cfg)
    elif args.cell in ("dn", "gc"):
        from ..engines import magnetized
        from . import magnetized as magnetized_row

        pre = magnetized_row.preset(args.cell, dev)
        state = magnetized_row.cast_state(pre.state, DTYPES[args.dtype])
        args.n = state.p.shape[0]
        step = magnetized.make_step(pre.config)
    elif args.cell == "bca":
        from .. import presets
        from ..engines import magnetized

        pre = presets.pic_bca_aps(device=dev)
        state = pre.state
        args.n = state.p.shape[0]
        step = magnetized.make_step(pre.config)
    elif args.cell == "sheath":
        from ..engines import sheath
        from . import sheath as sheath_row

        cfg, state = sheath_row.state(dev)
        args.n = state.p.shape[0]
        step = sheath.make_step(cfg)
    else:
        _, step, state = headline_state(args.n, dev, args.seed, args.ng,
                                        DTYPES[args.dtype],
                                        window_share=args.window_share)
    state, _ = run(step, state, 2)  # warm-up
    untraced = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run(step, state, args.steps)
        torch.cuda.synchronize()
        untraced.append((time.perf_counter() - t0) * 1e3 / args.steps)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, traced_m = run(step, state, args.steps)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3 / args.steps
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "profile_step.json"
    prof.export_chrome_trace(str(trace))
    (out / "profile_table.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))

    events = json.loads(trace.read_text())["traceEvents"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise RuntimeError("the trace holds no device activity")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        row = by_name[e["name"]]
        row[0] += e["dur"] / 1e3 / args.steps
        row[1] += 1
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    window = max(s[1] for s in spans) - min(s[0] for s in spans)
    busy = sum(e["dur"] for e in device) / 1e3 / args.steps
    syncs = sum(1 for e in events if e.get("ph") == "X"
                and e.get("name") == "cudaStreamSynchronize") / args.steps
    dtoh = sum(1 for e in device if "DtoH" in e["name"]) / args.steps
    kernels = sum(1 for e in device if e.get("cat") == "kernel") / args.steps
    print(f"[profile] untraced ms/step {', '.join(f'{t:.4f}' for t in untraced)}; "
          f"traced {traced:.4f}")
    print(f"[profile] device busy {busy:.4f} ms/step; idle share of the traced "
          f"window {1.0 - _busy_union(spans) / window:.3f}; "
          f"host syncs {syncs:.1f}/step, DtoH copies {dtoh:.1f}/step, "
          f"kernel launches {kernels:.1f}/step")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile] {ms:9.4f} ms/step  {count / args.steps:6.1f}/step  {name[:90]}")
    res = dict(cell=args.cell, n=args.n, steps=args.steps, dtype=args.dtype,
               untraced_ms_per_step=untraced,
               traced_ms_per_step=traced, device_busy_ms_per_step=busy,
               idle_share_traced=1.0 - _busy_union(spans) / window,
               host_syncs_per_step=syncs, dtoh_per_step=dtoh,
               kernels_per_step=kernels)
    if hasattr(traced_m, "picard_iters"):
        res["picard_passes_per_step"] = float(traced_m.picard_iters.float().mean())
        print(f"[profile] Picard passes {res['picard_passes_per_step']:.2f}/step")
    print(json.dumps(res))
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("drift", help="energy drift over many steps")
    d.add_argument("--steps", type=int, default=10_000)
    d.add_argument("--chunk", type=int, default=500)
    d.add_argument("--tol", type=float, default=None,
                   help="the Picard tolerance (default the conserving 1e-30)")
    d.add_argument("--maxiter", type=int, default=None,
                   help="the Picard passes at most (default the conserving 4)")
    p = sub.add_parser("profile", help="device time per step by kernel")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", required=True,
                   help="directory for the chrome trace and the table")
    p.add_argument("--cell", choices=("landau", "two-stream", "magnetized",
                                      "carried", "sheath", "dn", "gc", "bca"),
                   default="landau")
    p.add_argument("--window-share", choices=("auto", "shared", "separate"),
                   default="auto", help="the landau cell's Picard window (its "
                                        "conserving configuration's 'auto')")
    for s in (d, p):
        s.add_argument("--n", type=int, default=N_HEADLINE)
        s.add_argument("--seed", type=int, default=1)
        s.add_argument("--ng", type=int, default=NG,
                       help="grid nodes of the headline cell (L stays 22 "
                            "Debye lengths)")
        s.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                       help="the state's dtype (the landau and magnetized cells)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    drift(args) if args.cmd == "drift" else profile(args)


if __name__ == "__main__":
    main()
