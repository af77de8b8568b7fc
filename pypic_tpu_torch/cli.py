"""Command-line driver: run presets, write diagnostics/plots/gifs (the
counterpart of ``pypic_tpu/cli.py``).

The L10 layer, in place of the reference run scripts (run_pypic.py,
run_pypic_dd.py): clear the plot directory, run the simulation with
wall-clock timing written to ``time.out`` (run_pypic.py:12-17), dump the
text outputs (pypic.py:637-648), render summary frames and assemble gifs
(convert.py). The flags, their defaults and the files written are the JAX
CLI's.

Usage:
    python -m pypic_tpu_torch.cli list
    python -m pypic_tpu_torch.cli run landau_damping --steps 1000 --plot-every 100
    python -m pypic_tpu_torch.cli run two_stream --device cpu --particles 4000

Where it parts from the JAX CLI:

* ``--device`` (default: the card) goes to the preset; without a card it
  must be ``cpu``, or the run raises (``devices.resolve``): nothing falls
  back to the CPU on its own.
* ``--profile`` writes a ``torch.profiler`` trace (host and CUDA activity)
  to ``outdir/profile/trace.json``.
* The run's clock stops after the card's queue drains
  (``torch.cuda.synchronize``).
* Ranks: a domain preset runs one slab a rank. The process group comes
  from ``parallel.mesh.maybe_initialize_distributed`` (torchrun with
  ``PYPIC_DISTRIBUTED=1``, or the ``PYPIC_COORDINATOR`` variables), or is
  one the caller already made. ``--shards`` must equal the world size;
  only rank 0 writes to ``--outdir``; checkpoints hold JAX's global layout
  (``checkpoint.save`` with the mesh). ``--replicas R`` composes R
  data-parallel replicas with the slabs of ``domain_implicit`` and
  ``pic_iead_dd`` (the slabs x replicas mesh,
  ``parallel.mesh.make_mesh2``): the world is then shards x R ranks.
  ``--migrate-every k`` (``domain_implicit``, ``domain_explicit``) runs
  the migration-amortized superstep: one step call advances k steps,
  ``--steps`` and the checkpoint and dump cadences round up to multiples
  of k, and the metrics are written one row a step, as JAX's CLI does.

The figures (``--plot``, ``--gif``) need matplotlib and imageio: without
them those flags exit before the run, and ``viz`` is imported only for a
figure. The run's tensors stay on the device until it ends; metrics, the
final state for the plots and the text dumps then come to the host once
(particle dumps and checkpoints copy at their own cadence).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time

import numpy as np

_DOMAIN_PRESETS = ("domain_implicit", "domain_explicit", "pic_iead_dd")
# the presets that compose data-parallel replicas with their slabs
_REPLICA_PRESETS = ("pic_iead_dd", "domain_implicit")
# the presets that build the superstep (meta['steps_per_call'])
_SUPERSTEP_PRESETS = ("domain_implicit", "domain_explicit")


def _cmd_list(_args):
    from . import presets

    for name in sorted(presets.PRESETS):
        fn = presets.PRESETS[name]
        doc = (fn.__doc__ or "").strip().splitlines()[0]
        print(f"{name:24s} {doc}")


def _ranks_hint(shards: int) -> str:
    return (f"start {shards} ranks, one slab a rank: PYPIC_DISTRIBUTED=1 "
            f"torchrun --nproc-per-node {shards} -m pypic_tpu_torch.cli run "
            "..., or in each process PYPIC_COORDINATOR=host:port "
            f"PYPIC_NUM_PROCESSES={shards} PYPIC_PROCESS_ID=<rank>")


def _preset_kwargs(args) -> dict:
    pkw = {}
    if args.particles:
        pkw["n"] = args.particles
    if args.shards:
        pkw["shards"] = args.shards
    if args.replicas:
        pkw["replicas"] = args.replicas
    if args.migrate_every > 1:
        pkw["migrate_every"] = args.migrate_every
    for kv in args.opt or []:
        key, sep, val = kv.partition("=")
        if not sep or not key:
            sys.exit(f"--opt expects KEY=VALUE, got {kv!r}")
        try:
            val = int(val)
        except ValueError:
            try:
                val = float(val)
            except ValueError:
                pass
        pkw[key.replace("-", "_")] = val
    if args.device is not None:
        pkw["device"] = args.device
    return pkw


def _cmd_run(args):
    import torch
    import torch.distributed as dist

    from . import checkpoint, devices, diagnostics, presets
    from .parallel.mesh import maybe_initialize_distributed
    from .runner import run, run_thinned

    dev = devices.resolve(args.device)  # raises without a card, unless cpu
    # the figures need matplotlib (and the gif imageio): refuse before the
    # run rather than after it
    wanted = (["matplotlib"] if args.plot or args.gif else []) + (
        ["imageio"] if args.gif else [])
    absent = [m for m in wanted if importlib.util.find_spec(m) is None]
    if absent:
        sys.exit(f"--plot/--gif need {' and '.join(absent)}, which this "
                 "Python does not have; run without them")
    if args.replicas and args.preset not in _REPLICA_PRESETS:
        sys.exit(f"--replicas is not supported by preset {args.preset!r} "
                 f"({' and '.join(_REPLICA_PRESETS)} only)")
    if args.migrate_every > 1 and args.preset not in _SUPERSTEP_PRESETS:
        sys.exit(f"--migrate-every is not supported by preset "
                 f"{args.preset!r} (domain presets only)")
    # env-gated multi-process bootstrap before any preset builds its mesh
    if maybe_initialize_distributed(
            backend="nccl" if dev.type == "cuda" else "gloo"):
        print(f"distributed: process {dist.get_rank()} of "
              f"{dist.get_world_size()}", file=sys.stderr)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    reps = args.replicas or 1
    if (args.shards and args.shards * reps != world) or world % reps:
        sys.exit(f"--shards {args.shards} x --replicas {reps} but {world} "
                 "rank(s) run: " + _ranks_hint((args.shards or 1) * reps))

    def say(msg):
        if rank == 0:
            print(msg, file=sys.stderr)

    pkw = _preset_kwargs(args)
    try:
        preset = presets.get(args.preset, **pkw)
    except TypeError as e:
        # only claim a bad key when the error really is one (a TypeError
        # raised INSIDE the preset body must surface its own traceback)
        if "unexpected keyword argument" in str(e) and args.opt:
            sys.exit(f"an --opt key is not accepted by preset "
                     f"{args.preset!r} (see its signature in presets.py)")
        raise
    except NotImplementedError as e:
        sys.exit(f"preset {args.preset!r}: {e}")
    mesh = preset.meta.get("mesh")
    # migration-amortized supersteps: one step call advances spc steps and
    # stacks a (spc,) axis on the metrics
    spc = int(preset.meta.get("steps_per_call", 1))
    if "migrate_every" in pkw and spc != pkw["migrate_every"]:
        # a **kw preset would swallow the key silently, and the run would
        # not be the superstep it was asked for
        sys.exit(f"--migrate-every is not supported by preset "
                 f"{args.preset!r} (domain presets only)")
    if spc > 1:
        n_calls = -(-args.steps // spc)
        if n_calls * spc != args.steps:
            say(f"steps rounded up to {n_calls * spc} "
                f"(multiple of --migrate-every {spc})")
        args.steps = n_calls
        if args.plot_every:
            say("plot-every unsupported with --migrate-every; keeping "
                "full-cadence metrics")
            args.plot_every = 0
    if world > 1 and mesh is None:
        sys.exit(f"preset {args.preset!r} runs on one rank; only the domain "
                 f"presets split over {world} ranks")

    outdir = args.outdir
    if rank == 0:
        if os.path.isdir(outdir) and args.clean:
            shutil.rmtree(outdir)
        os.makedirs(outdir, exist_ok=True)
    if world > 1:
        dist.barrier()

    step = preset.make_step()
    state = preset.state
    mgr = None
    if args.checkpoint_every:
        # provenance marker: a rho/n leaf is only LIVE (updated past step 0)
        # under a carried config; resume uses it to decide whether a
        # restored rho can be trusted or must be re-primed from particles
        rho_live = (
            getattr(preset.config, "carried_deposit", "off") == "on"
            or getattr(preset.config, "carried_rho", "off") == "on"
        )
        mgr = checkpoint.CheckpointManager(
            os.path.join(outdir, "checkpoints"), every=args.checkpoint_every,
            async_write=args.async_checkpoint,
            extra={"rho_live": rho_live}, mesh=mesh,
        )
        if args.resume:
            state, manifest = mgr.restore(
                state,
                migrate=getattr(preset.engine, "CHECKPOINT_MIGRATIONS", None),
            )
            say(f"resumed from step {manifest['step']}")
            leaf_paths = manifest.get("leaf_paths", [])
            # a checkpoint from before the explicit engine carried rho/e
            # restores those leaves from the template (a different particle
            # configuration): recompute them from the restored positions
            from .engines import explicit as _explicit

            if preset.engine is _explicit and ".rho" not in leaf_paths:
                state = _explicit.refresh_fields(state, preset.config)
                say("refreshed carried rho/e from restored positions")
            # a pre-history checkpoint restores the extrapolated Picard
            # init's e_prev/e_prev2 (and the magnetized Newton warm start
            # phi_prev) from the template's step-0 fields: seed them from
            # the restored field instead
            refresh = {}
            for name in ("e_prev", "e_prev2"):
                if (hasattr(state, name) and hasattr(state, "e")
                        and f".{name}" not in leaf_paths):
                    refresh[name] = state.e
            if (hasattr(state, "phi_prev") and hasattr(state, "phi")
                    and ".phi_prev" not in leaf_paths):
                refresh["phi_prev"] = state.phi
            if refresh:
                state = state.replace(**refresh)
                say(f"seeded {sorted(refresh)} from the restored field "
                    "(pre-history checkpoint)")
            # carried configs: only a checkpoint WRITTEN under a carried
            # config holds a live rho (manifest extra rho_live); any other
            # restores step-0 zeros or a stale prime, so recompute from the
            # restored particles. A carried-written one is left untouched,
            # so that resume stays bit for bit on the CPU.
            ckpt_rho_live = (".rho" in leaf_paths
                             and manifest.get("extra", {}).get("rho_live", False))
            if (getattr(preset.config, "carried_deposit", "off") == "on"
                    and not ckpt_rho_live):
                from .engines import magnetized as _magnetized

                state = _magnetized.prime_carry(state, preset.config)
                say("re-primed carried rho/n from restored positions "
                    "(checkpoint written without a live carry)")
            if (getattr(preset.config, "carried_rho", "off") == "on"
                    and not ckpt_rho_live):
                from .parallel import domain as _domain

                state = _domain.prime_rho(state, preset.config, mesh)
                say("re-primed carried rho from restored positions "
                    "(checkpoint written without a live carry)")

    def _run_span(state, steps, thin):
        if thin:
            return run_thinned(step, state, steps, args.plot_every)
        return run(step, state, steps)

    prof = None
    if args.profile:
        # a trace for Perfetto / chrome://tracing (SURVEY.md §5: the
        # reference's only tracing is a wall-clock timer, run_pypic.py:13-17)
        from torch.profiler import ProfilerActivity, profile

        profile_dir = os.path.join(outdir, "profile")
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        say(f"profiling to {profile_dir}")

    # particle trajectory dump for the offline phase-space replay
    # (pypic_vpython.py:14 format: "x,v" rows, fixed particles per frame)
    dump_path = os.path.join(outdir, "particle_output.txt")
    if args.dump_particles and rank == 0 and os.path.exists(dump_path):
        os.unlink(dump_path)  # frames append per span; never mix runs

    def _dump_frame(st):
        if not args.dump_particles or rank != 0:
            return
        k = args.dump_particles
        x = st.p[:k].cpu().numpy() * preset.config.grid.dx
        v = st.v.cpu().numpy()
        v = (v[:, 0] if v.ndim == 2 else v)[:k]
        with open(dump_path, "a") as f:
            np.savetxt(f, np.stack([x, v], axis=-1), delimiter=",")

    # chunk the run when periodic checkpoints or particle dumps need the
    # state on the host mid-run (reference cadences: checkpoint every 100
    # steps, pygcpic.py:1627-1632; per-frame particle writes,
    # pygcpic.py:1440-1447)
    span_size = 0
    if mgr is not None:
        # cadences are in steps; spans count step calls (each one advances
        # spc steps under --migrate-every)
        ck_span = -(-mgr.every // spc)
        if spc > 1 and mgr.every % spc:
            say(f"checkpoint cadence rounded up to {ck_span * spc} "
                f"(multiple of --migrate-every {spc})")
        if args.steps > ck_span:
            span_size = ck_span
    if args.dump_particles and args.dump_every:
        dump_span = -(-args.dump_every // spc)
        if spc > 1 and args.dump_every % spc:
            say(f"dump cadence rounded up to {dump_span * spc} "
                f"(multiple of --migrate-every {spc})")
        if span_size and span_size != dump_span:
            say("dump-every follows checkpoint chunking cadence "
                f"({span_size * spc})")
        elif not span_size and dump_span <= args.steps:
            span_size = dump_span

    t0 = time.time()
    if span_size:
        # thinning must be uniform across every chunk or the metric rows
        # would mix cadences: off (with a warning) unless every span is
        # divisible by plot_every
        spans = []
        left = args.steps
        while left > 0:
            spans.append(min(span_size, left))
            left -= spans[-1]
        thin = bool(args.plot_every) and all(
            s % args.plot_every == 0 for s in spans)
        if args.plot_every and not thin:
            say("plot-every incompatible with chunking (span not "
                "divisible); keeping full-cadence metrics")
        final = state
        chunks = []
        done = 0
        for span in spans:
            final, m = _run_span(final, span, thin)
            chunks.append(m)
            done += span
            if mgr is not None:
                mgr.maybe_save(final, done * spc)
            _dump_frame(final)
        metrics = type(chunks[0])(*(torch.cat(cols) for cols in zip(*chunks)))
    else:
        thin = bool(args.plot_every) and args.steps % args.plot_every == 0
        final, metrics = _run_span(state, args.steps, thin)
        _dump_frame(final)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if mgr is not None:
        mgr.close()  # drain any in-flight async checkpoint write
    if prof is not None:
        prof.stop()
    elapsed = time.time() - t0
    if spc > 1:
        # (calls, spc, ...) -> (steps, ...): one row a step, in order
        metrics = type(metrics)(*(m.reshape((-1,) + tuple(m.shape[2:]))
                                  for m in metrics))
    n = preset.state.p.shape[0] * world
    sim_steps = args.steps * spc
    say(f"{sim_steps} steps x {n} particles in {elapsed:.1f}s "
        f"({n * sim_steps / elapsed:.3g} pushes/s)")

    if mgr is not None:
        checkpoint.save(os.path.join(outdir, "checkpoints", "final.npz"),
                        final, step=sim_steps, mesh=mesh)
    # the run's one move to the host: metrics, and the final state where a
    # plot or the post-process reads it (joined over the ranks)
    mdict = {k: v.cpu().numpy() for k, v in metrics._asdict().items()}
    fin = (checkpoint.host_arrays(final, mesh)
           if args.plot or args.bca_postprocess else {})
    if rank != 0:
        return

    if prof is not None:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    # wall-clock timing file (run_pypic.py:16-17)
    with open(os.path.join(outdir, "time.out"), "w") as f:
        print(elapsed, file=f)

    # metric dump as npz + JSONL scalars
    np.savez(os.path.join(outdir, "metrics.npz"), **mdict)
    with open(os.path.join(outdir, "metrics.jsonl"), "w") as f:
        num = len(next(iter(mdict.values())))
        for i in range(num):
            row = {k: float(v[i]) for k, v in mdict.items() if v.ndim == 1}
            print(json.dumps(row), file=f)

    # text dumps (pypic.py:637-648) for engines exposing the fields
    if "field_energy" in mdict:
        params = preset.meta.get("params")
        meta_params = {}
        if params is not None:
            meta_params = dict(wp=params.wp, G=params.growth_rate,
                               tau=1.0 / params.wp, p2c=params.p2c)
        meta_params.update(dt=preset.config.dt, Ng=preset.config.grid.ng,
                           L=preset.config.grid.length)
        current = mdict.get("current_bias", np.zeros(1))
        diagnostics.write_run_outputs(outdir, mdict["field_energy"], current,
                                      meta_params)

    # pic_iead end-of-run surface post-process (pygcpic.py:1296-1305): the
    # accumulated IEADs through the BCA, the budget printed and written
    if args.bca_postprocess and "iead" in fin:
        from . import bca as bca_mod

        # incident species per IEAD row from the preset (default: pic_iead's
        # D and B, pygcpic.py:1147-1180)
        (m_src, z_src), (m_wall, z_wall) = preset.meta.get(
            "bca_incident", ((2.0, 1), (10.81, 5)))
        stats = bca_mod.postprocess_iead(
            fin["iead"], preset.config.iead_energy_max,
            preset.config.iead_angle_max,
            bca_mod.BinaryCollisionModel(incident_m_amu=m_src,
                                         incident_z=z_src),
            bca_mod.BinaryCollisionModel(incident_m_amu=m_wall,
                                         incident_z=z_wall),
        )
        say(  # the reference's budget line (pygcpic.py:1305)
            f"num_deposited: {stats['num_deposited_wall']:.0f}, "
            f"num_sputtered: {stats['num_sputtered']}, "
            f"{stats['num_reflected_wall']}, "
            f"{stats['num_incident_wall']:.0f}")
        with open(os.path.join(outdir, "bca_postprocess.json"), "w") as f:
            json.dump({k: v for k, v in stats.items() if np.isscalar(v)}, f,
                      indent=1)

    # phase-space gif from the per-span particle dump (run_pypic.py:19-21's
    # gif assembly / pypic_vpython.py replay, as one offline post-process)
    if args.gif:
        if not (args.dump_particles and os.path.exists(dump_path)):
            say("--gif needs --dump-particles frames; skipping")
        else:
            from . import viz

            xs, vs = viz.load_particle_dump(dump_path, args.dump_particles)
            gif_path = os.path.join(outdir, "phase_space.gif")
            viz.phase_space_replay(gif_path, xs, vs)
            say(f"wrote {gif_path}")

    # IEAD heatmap + BCA run dashboard for the magnetized states: the
    # offline equivalents of pic_iead's live pcolormesh figures
    # (pygcpic.py:1283-1298) and the pic_bca_aps 8-figure dashboard
    # (pygcpic.py:1634-1702)
    if (args.plot and "iead" in fin
            and preset.config.iead_energy_max > 0):
        from . import viz

        cfg = preset.config
        labels = preset.meta.get("species_labels") or [
            f"Z{z}" for z in cfg.species_z]
        viz.iead_figure(os.path.join(outdir, "iead.png"), fin["iead"],
                        cfg.iead_energy_max, cfg.iead_angle_max, labels)
        wrote = [f"{outdir}/iead.png"]
        if "iead_out" in fin:
            act = fin["active"] == 1
            xp = fin["p"][act] * cfg.grid.dx
            vxp = fin["vx"][act]
            rho = mdict["rho"][-1] if "rho" in mdict else fin["rho"]
            viz.bca_figure(
                os.path.join(outdir, "bca_dashboard.png"), xp, vxp,
                np.sqrt(vxp.var()) + 1e-300, fin["phi"], rho, fin["iead"],
                fin["iead_out"], cfg.iead_energy_max, cfg.iead_angle_max,
                cfg.grid.length, labels,
            )
            wrote.append(f"{outdir}/bca_dashboard.png")
        say(f"wrote {' + '.join(wrote)}")

    # summary plot for the periodic engines
    if (args.plot and "v" in fin and fin["v"].ndim == 1
            and "e" in fin and "j" in fin):
        from . import viz

        params = preset.meta.get("params")
        xp, vp = fin["p"], fin["v"]
        if "alive" in fin:  # domain states: drop dead slots
            xp, vp = xp[fin["alive"]], vp[fin["alive"]]
        vth = np.sqrt(vp.var()) + 1e-300
        # scalar metrics are full-cadence even under --plot-every thinning
        # (run_thinned thins only heavy array rows)
        times = np.arange(len(mdict["field_energy"])) * preset.config.dt
        viz.summary_figure(
            os.path.join(outdir, "summary.png"), xp * preset.config.grid.dx,
            vp, vth, mdict["field_energy"], times,
            params.wp if params else 1.0,
            params.growth_rate if params else None,
            fin["e"], fin["j"], preset.config.grid.length,
            system=preset.meta.get("system", preset.name),
        )
        say(f"wrote {outdir}/summary.png")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pypic_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("list", help="list available presets")
    lp.set_defaults(fn=_cmd_list)

    rp = sub.add_parser("run", help="run a preset")
    rp.add_argument("preset")
    rp.add_argument("--steps", type=int, default=100)
    rp.add_argument("--particles", type=int, default=None)
    rp.add_argument("--device", default=None,
                    help="where the run's tensors live (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    rp.add_argument("--shards", type=int, default=None,
                    help="slabs of the domain-decomposed presets, one a "
                         "rank: must equal the number of ranks started "
                         "(default: that number)")
    rp.add_argument("--replicas", type=int, default=None,
                    help="data-parallel replicas composed with the slab "
                         "axis (slabs x replicas ranks) for domain_implicit "
                         "and pic_iead_dd")
    rp.add_argument("--migrate-every", type=int, default=1,
                    help="domain_implicit, domain_explicit: amortize "
                         "particle migration over this many micro-steps a "
                         "superstep (the halo scales to cover the k-step "
                         "excursion; --steps rounds up to a multiple)")
    rp.add_argument("--opt", action="append", metavar="KEY=VALUE",
                    help="extra preset keyword, repeatable (e.g. --opt "
                         "field_solve=distributed --opt carried_rho=on); "
                         "ints/floats auto-coerced, '-' mapped to '_'")
    rp.add_argument("--outdir", default="plots")
    rp.add_argument("--plot-every", type=int, default=0,
                    help="thin metrics to every k steps (reference nplot)")
    rp.add_argument("--plot", action="store_true", help="write summary.png")
    rp.add_argument("--gif", action="store_true",
                    help="assemble a phase-space gif from the particle dump "
                         "frames (needs --dump-particles/--dump-every; "
                         "run_pypic.py:19-21 gif assembly as offline "
                         "post-process)")
    rp.add_argument("--checkpoint-every", type=int, default=0)
    rp.add_argument("--async-checkpoint", action="store_true",
                    help="write checkpoints on a background thread (the "
                         "step loop only pays the device-to-host copy; "
                         "atomicity and resume unchanged)")
    rp.add_argument("--resume", action="store_true")
    rp.add_argument("--clean", action="store_true",
                    help="clear outdir first (run_pypic.py:8-10)")
    rp.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace to outdir/profile")
    rp.add_argument("--dump-particles", type=int, default=0,
                    help="append (x, v) rows for the first K particles to "
                         "particle_output.txt for the phase-space replay "
                         "(pypic_vpython.py format)")
    rp.add_argument("--dump-every", type=int, default=0,
                    help="particle-dump cadence in steps (chunks the run)")
    rp.add_argument("--bca-postprocess", action="store_true",
                    help="feed the end-of-run IEADs through the surface "
                         "model (pic_iead post-process, pygcpic.py:1299-1305)")
    rp.set_defaults(fn=_cmd_run)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
