"""The compiled code of the float kernels against another tree's, and the
atomics of the double kernels.

    python -m pypic_tpu_torch.tools.sass_diff --parent DIR [--out FILE]

``DIR`` holds another tree's ``csrc/``, e.g. the parent commit's from
``git archive``. Each ``.cu`` source of this tree's ``csrc/`` (every one
includes ``cic_common.cuh``) is compiled from both trees to a cubin for
``sm_90a`` with the package's flags, all at once, and ``cuobjdump -sass``
lists each kernel's machine code. A kernel of ``DIR`` is matched with the
kernel of this tree of the same mangled name, else of the same name,
integral template arguments and element type (a float kernel of ``DIR``
without one matches the float instantiation here: the templates gained
that argument with the double kernels of a float64 state), and their
instructions are compared with the addresses and encodings left out.
The float kernels of ``DIR`` decide the exit code; its double kernels
are compared too and reported beside this tree's, and this tree's float
kernels that ``DIR`` lacks are listed as new. Each double kernel's
atomic instructions are counted by opcode: a shared-memory double add
may compile to a compare-and-swap loop (ATOMS.CAS), a global one to RED
or ATOM.

Prints one line a kernel and one JSON line; exits non-zero when a float
kernel of ``DIR`` is missing here or compiles to other code. Needs
``nvcc`` and ``cuobjdump`` (the CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from ..ops import _build

SOURCES = tuple(sorted(p.name for p in _build.CSRC_DIR.glob("*.cu")))


def _tool(name: str) -> str:
    return str(Path(_build._nvcc()).parent / name)


def sass(src: Path, workdir: Path) -> dict:
    """{mangled name: [instructions]} of the kernels of ``src`` compiled
    to a cubin with the package's flags (the instructions without their
    addresses and encodings)."""
    cubin = workdir / (src.stem + ".cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(cubin), str(src)],
                   check=True, capture_output=True, text=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        if name is None:
            continue
        ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
        if ins and not ins.startswith("."):
            out[name].append(ins)
    return out


def _key(mangled: str) -> tuple:
    """(name, integral template arguments, element type or None)."""
    name, args = _build._kernel_of(mangled)
    ints = tuple(a for a in args if isinstance(a, int))
    types = [a for a in args if isinstance(a, str)]
    return name, ints, types[0] if types else None


def atomics(instructions: list) -> dict:
    """Count of each atomic or reduction opcode (with its modifiers)."""
    ops = collections.Counter()
    for ins in instructions:
        op = ins.split()[0] if not ins.startswith("@") else ins.split()[1]
        if op.startswith(("ATOM", "RED")):
            ops[op] += 1
    return dict(ops)


def _same(here, body) -> str:
    if here is None:
        return "missing"
    if here == body:
        return f"identical ({len(body)} instructions)"
    diff = sum(a != b for a, b in zip(here, body)) + abs(len(here) - len(body))
    return f"differs: {diff} of {len(body)} instructions ({len(here)} now)"


def compare(parent: Path) -> dict:
    res = {"float": {}, "double": {}, "new float": {}}
    parent_double = {}
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(8) as pool:
        (Path(tmp) / "old").mkdir()
        (Path(tmp) / "new").mkdir()
        jobs = {src: (pool.submit(sass, parent / "csrc" / src, Path(tmp) / "old"),
                      pool.submit(sass, _build.CSRC_DIR / src, Path(tmp) / "new"))
                for src in SOURCES}
        for src, (old_job, new_job) in jobs.items():
            old, new = old_job.result(), new_job.result()
            new_by_key = {_key(k): v for k, v in new.items()}
            matched = set()
            for mangled, body in old.items():
                name, ints, typ = _key(mangled)
                here = new.get(mangled, new_by_key.get(
                    (name, ints, typ or "f"),
                    None if typ else new_by_key.get((name, ints, None))))
                matched.update({(name, ints, typ or "f"), (name, ints, None)})
                label = f"{src} {name}{list(ints)}"
                if typ == "d":
                    parent_double[label] = _same(here, body)
                else:
                    res["float"][label] = _same(here, body)
            for (name, ints, typ), body in new_by_key.items():
                if typ != "d" and (name, ints, typ) not in matched:
                    res["new float"][f"{src} {name}{list(ints)}"] = dict(
                        instructions=len(body), atomics=atomics(body))
                if typ == "d":
                    label = f"{src} {name}{list(ints)}"
                    res["double"][label] = dict(
                        instructions=len(body), atomics=atomics(body),
                        parent=parent_double.get(label, "new"))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a tree whose csrc/ holds the other sources")
    ap.add_argument("--out", type=Path, default=None, help="write the JSON there too")
    args = ap.parse_args(argv)
    res = compare(args.parent)
    for label, what in res["float"].items():
        print(f"[sass] float {label}: {what}")
    for label, what in res["new float"].items():
        print(f"[sass] new float {label}: {what['instructions']} instructions, "
              f"atomics {what['atomics']}")
    for label, what in res["double"].items():
        print(f"[sass] double {label}: {what['instructions']} instructions, "
              f"atomics {what['atomics']}; against the parent's: {what['parent']}")
    line = json.dumps(res)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    same = all(v.startswith("identical") for v in res["float"].values())
    print(f"[sass] {sum(v.startswith('identical') for v in res['float'].values())} of "
          f"{len(res['float'])} float kernels compile to the parent's code; "
          f"{len(res['double'])} double kernels, "
          f"{sum(v['parent'].startswith('identical') for v in res['double'].values())} "
          f"of them the parent's code, {sum(v['parent'] == 'new' for v in res['double'].values())} new")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
