"""Where a launch of the resident implicit kernel spends its time, on the
card: copies of a kernel source with one stage cut out, each built by nvcc
into its own library outside the package's.

    python -m pypic_tpu_torch.tools.resident_split [--first-port SOURCE]

The cuts are text edits of ``csrc/implicit.cu`` (the edits are written
against that source and fail loudly when it changes). With
``--first-port`` the tool also splits the first port's kernel (one 8-CTA
cluster, the particles in device memory), given its source file, for
example from ``git show 64e2430:pypic_tpu_torch/csrc/implicit.cu``. Each
cut runs at the configs[1] row's shape (tools/landau.py: n = 1e5, ng =
200, one 64-step launch, tol 1e-6, maxiter 50, picard_init 'field', no
Anderson); a cut that changes the arithmetic runs the pass counts the
full kernel ran. Times are CUDA events, the median of five launches,
two rounds; the tool prints the atomic instructions each full kernel
compiles to (cuobjdump) and one JSON line. It needs an NVIDIA GPU and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..constants import EPSILON_0
from ..engines import implicit
from ..ops import _build, cuda_cic
from . import landau

OUT_DIR = _build.BUILD_DIR / "resident_split"

# the current kernel: CUT selects the stage taken out
CURRENT_CUTS = {
    "full": 0,
    "no deposit": 1,           # the sweeps without their atomics
    "no sweeps": 2,            # the (ng,) chain and the barriers alone
    "no sweeps, no cluster barrier": 3,  # __syncthreads in its place
    "no sweeps, local push": 4,  # every CTA's totals stored locally
    "no sweeps, no combine or push": 5,
    "no sweeps, barriers only": 6,
}
_CURRENT_EDITS = [
    ("#include \"cic_common.cuh\"",
     "#include \"cic_common.cuh\"\n#ifndef CUT\n#define CUT 0\n#endif"),
    ("int smooth, int tracer, double fe_c, double ke_c, double jb_c) {\n  cg::cluster_group",
     "int smooth, int tracer, double fe_c, double ke_c, double jb_c,\n"
     "    const int* __restrict__ forced) {\n  float sink = 0.0f;\n  cg::cluster_group"),
    ("    while (r > tol && k < maxiter) {",
     "    while (forced ? k < forced[s] : (r > tol && k < maxiter)) {"),
    ("      const bool last = !(r > tol && k < maxiter);",
     "      const bool last = forced ? k >= forced[s] : !(r > tol && k < maxiter);"),
    ("        if (j * kThreads < lim) {\n          const float a = P[j]",
     "        if (CUT < 2 && j * kThreads < lim) {\n          const float a = P[j]"),
    ("          atomicAdd(&hist[c.l * cols + col], __fmul_rn(val, c.wl));\n"
     "          atomicAdd(&hist[c.r * cols + col], __fmul_rn(val, c.wr));",
     "          if (CUT == 1) {\n"
     "            sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(val, c.wl), __fmul_rn(val,"
     " c.wr)) + (float)(c.l * cols + col));\n          } else {\n"
     "          atomicAdd(&hist[c.l * cols + col], __fmul_rn(val, c.wl));\n"
     "          atomicAdd(&hist[c.r * cols + col], __fmul_rn(val, c.wr));\n          }"),
    ("      if (node) {\n        // node t's columns",
     "      if (CUT < 5 && node) {\n        // node t's columns"),
    ("*cluster.map_shared_rank(slot, q) = x;",
     "*cluster.map_shared_rank(slot, CUT == 4 ? rank : q) = x;"),
    ("      cluster.sync();  // recv[b] is complete in every CTA",
     "      if (CUT == 3) __syncthreads(); else cluster.sync();\n      if (CUT != 6) {"),
    ("        write_partials(tot, s - 1, ke_row, jb_row, ke_c, jb_c);\n\n      // (B2)",
     "        write_partials(tot, s - 1, ke_row, jb_row, ke_c, jb_c);\n"
     "      } else __syncthreads();\n      if (CUT != 6) {\n\n      // (B2)"),
    ("      __syncthreads();\n\n"
     "      // (B3) r, the mixed iterate and the next sweep's field\n"
     "      double rs = 0.0;\n      for (int q = 0; q < nw; ++q) rs += red_r[4 * q];",
     "      }\n      __syncthreads();\n\n      double rs = 0.0;\n"
     "      if (CUT != 6) for (int q = 0; q < nw; ++q) rs += red_r[4 * q];"),
    ("      const bool last = forced ? k >= forced[s] : !(r > tol && k < maxiter);\n"
     "      if (node) {",
     "      const bool last = forced ? k >= forced[s] : !(r > tol && k < maxiter);\n"
     "      if (CUT != 6 && node) {"),
    ("      if (j * kThreads < lim) {\n        const float e = gather_rec(fs",
     "      if (CUT < 2 && j * kThreads < lim) {\n        const float e = gather_rec(fs"),
    ("  if (rank == 0 && node) {\n    e_out[t]",
     "  if (sink == 1.2345e30f) e_out[1] = sink;\n  if (rank == 0 && node) {\n    e_out[t]"),
    ("    int tracer, double fe_c, double ke_c, double jb_c, void* stream) {",
     "    int tracer, double fe_c, double ke_c, double jb_c, const int* forced,\n"
     "    void* stream) {"),
    ("      fe_c, ke_c, jb_c);\n  if (err != cudaSuccess) return (int)err;",
     "      fe_c, ke_c, jb_c, forced);\n  if (err != cudaSuccess) return (int)err;"),
]

# the first port's kernel: mode selects the stage taken out
FIRST_PORT_CUTS = {
    "(a) as is": 0,
    "(b) no particle sweeps": 1,
    "(c) sweeps without the shared-memory atomics": 2,
    "(d) DSMEM histogram sum and block_sums alone": 3,
    "(e) cluster barriers alone": 4,
    "(f) sweeps and cluster barriers alone": 5,
}
_FIRST_PORT_EDITS = [
    ("#include <cooperative_groups.h>",
     "#include <cooperative_groups.h>\n#ifndef RP\n#define RP\n#endif"),
    ("const float* __restrict__ v_in, float* p, float* v, float* ps,",
     "const float* __restrict__ v_in, float* RP p, float* RP v, float* RP ps,"),
    ("int anderson, int smooth, int tracer, double fe_c, double ke_c,\n    double jb_c) {",
     "int anderson, int smooth, int tracer, double fe_c, double ke_c,\n"
     "    double jb_c, int mode, const int* __restrict__ forced) {\n"
     "  const bool sweeps = mode == 0 || mode == 2 || mode == 5;\n"
     "  const bool chain = mode <= 2;\n  const bool sums = mode <= 3;\n  float sink = 0.0f;"),
    ("while (r > tol && k < maxiter) {",
     "while (mode == 0 ? (r > tol && k < maxiter) : k < forced[s]) {"),
    ("      for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);\n"
     "      __syncthreads();\n      const int b = pass & 1;",
     "      if (chain) {\n"
     "      for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);\n"
     "      __syncthreads();\n      }\n      const int b = pass & 1;"),
    ("      for (int i = begin + t; i < end; i += kThreads) {\n"
     "        const float a = p[i];",
     "      if (sweeps) for (int i = begin + t; i < end; i += kThreads) {\n"
     "        const float a = p[i];"),
    ("        atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));\n"
     "        atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));",
     "        if (mode == 2) {\n"
     "          sink = __fadd_rn(sink, __fadd_rn(__fmul_rn(val, c.wl), __fmul_rn(val,"
     " c.wr)) + (float)(c.l + c.r));\n        } else {\n"
     "        atomicAdd(&hist[c.l], __fmul_rn(val, c.wl));\n"
     "        atomicAdd(&hist[c.r], __fmul_rn(val, c.wr));\n        }"),
    ("      double sj = 0.0;\n      for (int i = t; i < ng; i += kThreads) {\n"
     "        float jh = 0.0f;",
     "      double sj = 0.0;\n      if (sums) for (int i = t; i < ng; i += kThreads) {\n"
     "        float jh = 0.0f;"),
    ("      const float mean = (float)(block_sum(sj, red) / ng);  // syncs s_jh\n"
     "      double rr = 0.0;\n      for (int i = t; i < ng; i += kThreads) {",
     "      const float mean = sums ? (float)(block_sum(sj, red) / ng) : 0.0f;\n"
     "      double rr = 0.0;\n      if (chain) for (int i = t; i < ng; i += kThreads) {"),
    ("      r = (float)block_sum(rr, red);\n      if (anderson) {",
     "      if (sums) r = (float)block_sum(rr, red);\n      if (anderson && sums) {"),
    ("      } else {\n        for (int i = t; i < ng; i += kThreads) s_es[i] = s_fs[i];\n"
     "      }\n      __syncthreads();\n      ++k;",
     "      } else if (chain) {\n"
     "        for (int i = t; i < ng; i += kThreads) s_es[i] = s_fs[i];\n      }\n"
     "      if (chain) __syncthreads();\n      ++k;"),
    ("    for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);\n"
     "    __syncthreads();\n    const float* gpos = k == 0 ? p : ps;\n"
     "    double ke = 0.0, jb = 0.0;\n    for (int i = begin + t; i < end; i += kThreads) {",
     "    if (chain) {\n"
     "    for (int i = t; i < ng; i += kThreads) s_fs[i] = smooth_at(s_es, i, ng, sm);\n"
     "    __syncthreads();\n    }\n    const float* gpos = k == 0 ? p : ps;\n"
     "    double ke = 0.0, jb = 0.0;\n"
     "    if (sweeps) for (int i = begin + t; i < end; i += kThreads) {"),
    ("    ke = block_sum(ke, red);\n    jb = block_sum(jb, red);",
     "    if (sums) {\n    ke = block_sum(ke, red);\n    jb = block_sum(jb, red);\n    }"),
    ("    double fe = 0.0;\n    for (int i = t; i < ng; i += kThreads) {",
     "    double fe = 0.0;\n    if (chain) for (int i = t; i < ng; i += kThreads) {"),
    ("    fe = block_sum(fe, red);\n"
     "    cluster.sync();  // part[sb] is complete in every CTA\n"
     "    if (rank == 0 && t == 0) {",
     "    if (sums) fe = block_sum(fe, red);\n    cluster.sync();\n"
     "    if (rank == 0 && t == 0 && sums) {"),
    ("  cluster.sync();  // no CTA exits while another may still read its memory\n",
     "  cluster.sync();\n  if (sink == 1.2345e30f) e_out[0] = sink;\n"),
    ("int tracer, double fe_c, double ke_c, double jb_c, void* stream) {",
     "int tracer, double fe_c, double ke_c, double jb_c, int mode, const int* forced,\n"
     "    void* stream) {"),
    ("      jb_c);\n  return (int)cudaGetLastError();",
     "      jb_c, mode, forced);\n  return (int)cudaGetLastError();"),
]

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_CURRENT_ARGS = [_P] * 17 + [_I] * 5 + [_F] * 7 + [_I] * 5 + [_D] * 3 + [_P, _P]
_FIRST_PORT_ARGS = [_P] * 18 + [_I] * 3 + [_F] * 7 + [_I] * 5 + [_D] * 3 + [_I, _P, _P]


def _edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the cut's anchor is not in the source once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _build_all(jobs) -> dict:
    """jobs: {tag: (source text, extra nvcc flags)} -> {tag: loaded CDLL},
    one nvcc each, all at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (text, flags) in jobs.items():
        stem = tag.replace(" ", "_").replace(",", "").replace("(", "").replace(")", "")
        src = OUT_DIR / f"{stem}.cu"
        src.write_text(text)
        lib = OUT_DIR / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR),
               *flags, "-o", str(lib), str(src)]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines() if "spill" in line})
        print(f"[build] {tag}: {'; '.join(spills)}", flush=True)
        libs[tag] = ctypes.CDLL(str(lib))
    return libs


def _atomics(lib_path: Path) -> dict:
    """Shared-memory atomic opcodes in a library's SASS, by count."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    counts = {}
    for line in sass.splitlines():
        for word in line.replace(";", " ").split():
            if word.startswith("ATOMS"):
                counts[word] = counts.get(word, 0) + 1
    return counts


def _timed(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first-port", type=Path,
                    help="the first port's csrc/implicit.cu, split as well")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    jobs = {}
    current = _edited((_build.CSRC_DIR / "implicit.cu").read_text(), _CURRENT_EDITS)
    for tag, cut in CURRENT_CUTS.items():
        jobs[tag] = (current, [f"-DCUT={cut}"])
    if args.first_port:
        first = _edited(args.first_port.read_text(), _FIRST_PORT_EDITS)
        for tag in FIRST_PORT_CUTS:
            jobs[tag] = (first, [])
        jobs["(a') restrict"] = (first, ["-DRP=__restrict__"])
    libs = _build_all(jobs)
    for tag in ("full", "(a) as is"):
        if tag in libs:
            print(f"[sass] {tag}: {_atomics(Path(libs[tag]._name))}", flush=True)

    cfg, st = landau.state(landau.N, dev)
    kw = implicit.resident_kwargs(st, cfg)
    ng, steps, n = cfg.grid.ng, landau.STEPS_PER_CALL, landau.N
    shape = cuda_cic.implicit_resident_shape(n, ng)
    qm_dt, qm_dt2_half, dt_dx, wf = cuda_cic.kernel_scalars(kw["qm"], kw["dt"], kw["dx"], kw["w"])
    scalars = (qm_dt, qm_dt2_half, dt_dx, wf, cuda_cic._inv(ng),
               float(np.float32(kw["dt"] / EPSILON_0)), float(np.float32(kw["tol"])),
               int(kw["maxiter"]), int(kw["extrapolate"]))
    anderson = int(kw["anderson"])
    tail = (int(kw["smooth"]), int(kw["tracer"]), float(kw["fe_c"]), float(kw["ke_c"]),
            float(np.float32(wf) / np.float32(ng)))
    p1, v1, ps = torch.empty_like(st.p), torch.empty_like(st.v), torch.empty_like(st.p)
    fields = torch.empty((3, ng), dtype=torch.float32, device=dev)
    rows = torch.zeros((6, steps), dtype=torch.float32, device=dev)
    iters = torch.zeros((steps,), dtype=torch.int32, device=dev)
    inputs = [t.data_ptr() for t in (st.e, st.e_prev, st.j, st.p, st.v, p1, v1)]
    outputs = [t.data_ptr() for t in (fields[0], fields[1], fields[2], rows[0], rows[1],
                                      rows[2], iters, rows[3], rows[4], rows[5])]
    stream = torch.cuda.current_stream().cuda_stream
    # the pass counts of the full kernel, which every cut runs
    ref = cuda_cic.implicit_resident(st.e, st.e_prev, st.j, st.p, st.v, ng, steps, **kw)
    forced = ref[5]["iters"].clone()
    passes = int(forced.sum())

    def current_call(lib, cut):
        err = lib.pypic_implicit_resident(
            *inputs, *outputs, n, shape.per_cta, ng, shape.cols, steps, *scalars,
            anderson, *tail, forced.data_ptr() if cut else None, stream)
        _build.check(err, "resident_split")

    def first_port_call(lib, mode):
        err = lib.pypic_implicit_resident(
            *inputs, ps.data_ptr(), *outputs, n, ng, steps, *scalars, anderson,
            *tail, mode, forced.data_ptr(), stream)
        _build.check(err, "resident_split")

    for tag, lib in libs.items():
        lib.pypic_implicit_resident.argtypes = (
            _CURRENT_ARGS if tag in CURRENT_CUTS else _FIRST_PORT_ARGS)
        lib.pypic_implicit_resident.restype = _I
    res = {"device": torch.cuda.get_device_name(0), "n": n, "ng": ng, "steps": steps,
           "passes": passes, "ms": {}}
    for rnd in range(2):
        for tag, lib in libs.items():
            if tag in CURRENT_CUTS:
                cut = CURRENT_CUTS[tag]
                ms = _timed(lambda: current_call(lib, cut))
            else:
                mode = FIRST_PORT_CUTS.get(tag, 0)
                ms = _timed(lambda: first_port_call(lib, mode))
            res["ms"].setdefault(tag, []).append(ms)
            print(f"[split] {tag}: {ms:.4f} ms, {ms * 1e3 / passes:.3f} us a pass", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
