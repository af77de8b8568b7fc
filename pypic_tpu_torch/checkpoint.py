"""Checkpoint and resume (the counterpart of ``pypic_tpu/checkpoint.py``).

The reference pickles its whole particle list and grid object every 100
steps, with no versioning or atomicity (pygcpic.py:1627-1632, loaded at
1378-1383). Here an engine state's leaves go into a numpy ``.npz`` with a
JSON manifest, written atomically (tmp + rename), so a crash during a
save never corrupts the last checkpoint.

The container is the JAX package's, format 2: the leaves are stored under
the JAX state's field paths (``.p``, ``.vx``, ..., ``.rng``, ``.step``),
so a JAX checkpoint of a state loads into the port's template of the same
engine and the other way round. A port state's leaves are its dataclass
fields that hold tensors, in field order, and ``rng``: the Philox key
words, stored as the JAX state stores its key data (two uint32 words;
``interop._keyed_from_numpy`` maps them the same way). The host copies a
state keeps (``step_host``, ``qm_host``) are not stored: the state
rebuilds them when it is made on load.

The slab-sharded states (``parallel.domain``, ``parallel.domain_implicit``,
``parallel.domain_sheath``, ``parallel.domain_magnetized``; their layouts
in ``interop.domain_layout``) hold one rank's rows. Given the rank's ``mesh``, ``save`` gathers every
rank's rows in rank order and rank 0 writes one file in JAX's global
layout: each per-particle leaf (S x capacity,), each slab leaf (ng,), the
scalars once, the leaf paths and shapes of ``pypic_tpu.checkpoint.save``
for the JAX preset at the same shards. ``load`` reads that file on every
rank and keeps the rank's own rows. Every rank calls both. At one rank
(or without a mesh) nothing is gathered or cut. On a slabs x replicas
mesh (a ``Mesh2``) the per-particle leaves are joined over every rank in
rank order s R + r (JAX's (S, R, cap_r) layout) and the slab leaves over
the slabs. A data-parallel state of a single-slab engine (its mesh a
``SlabMesh`` of more than one rank) joins its per-particle fields
(``parallel.dataparallel.particle_fields``) the same way: the file holds
the whole population in the one-device layout, and ``load`` cuts it into
the ranks' contiguous blocks again.

A save and a load give every leaf back bit for bit. On the CPU (the plain
kernel versions, a fixed summation order) a resumed run is bit-exact with
the uninterrupted one; on the card the deposits add with float atomics,
so a resumed run agrees with it at the step-parity tolerances, not bit
for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

# v2: leaves stored with their field paths, so a field added to a state
# never breaks restoring an older checkpoint (the new leaf takes the
# template's value); v1 matched leaves by position
_FORMAT_VERSION = 2


def _flatten_with_paths(state):
    """(paths, leaves) of a port state: its tensor fields and ``rng`` (as a
    (2,) uint32 array), each under the JAX field path ``.name``."""
    paths, leaves = [], []
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if f.name == "rng":
            value = np.asarray(value, np.uint32)
        elif not isinstance(value, torch.Tensor):
            continue  # a host copy the state rebuilds
        paths.append(f".{f.name}")
        leaves.append(value)
    return paths, leaves


def _to_host(leaves):
    """The leaves as host numpy arrays: the device-synchronous part of a
    save (one device-to-host copy a tensor)."""
    return [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in leaves]


def _root(mesh):
    """The mesh of every rank (a ``Mesh2``'s world), or None."""
    from .parallel.mesh import Mesh2

    return mesh.world if isinstance(mesh, Mesh2) else mesh


def _sharded_fields(state, mesh) -> dict:
    """{field: the mesh its rows are split over} for the fields of
    ``state`` whose rows are the rank's own: empty on one rank."""
    from . import interop
    from .parallel import dataparallel
    from .parallel.mesh import Mesh2

    root = _root(mesh)
    if root is None or root.world == 1:
        return {}
    layout = interop.domain_layout(type(state))
    if layout is None:  # a data-parallel state: the particle blocks
        return {name: root for name in dataparallel.particle_fields(state)}
    slabs = mesh.slabs if isinstance(mesh, Mesh2) else mesh
    return {**{name: root for name in layout[0]},
            **{name: slabs for name in layout[1]}}


def _gathered(state, mesh):
    """(paths, host arrays) of a state, every sharded leaf joined over
    its ranks in rank order (a collective: every rank calls it)."""
    paths, leaves = _flatten_with_paths(state)
    sharded = _sharded_fields(state, mesh)
    joined = []
    for p, leaf in zip(paths, leaves):
        over = sharded.get(p[1:])
        if over is not None:
            # bool travels as uint8 (NCCL has no bool)
            whole = over.all_gather(leaf.to(torch.uint8) if leaf.dtype == torch.bool
                                    else leaf)
            leaf = whole.to(torch.bool) if leaf.dtype == torch.bool else whole
        joined.append(leaf)
    return paths, _to_host(joined)


def host_arrays(state, mesh=None) -> dict:
    """{field name: host numpy array} of a state's leaves as ``save``
    stores them: the sharded leaves joined over the ranks (a collective
    with a mesh of more than one rank: every rank calls it)."""
    paths, arrays = _gathered(state, mesh)
    return {p[1:]: a for p, a in zip(paths, arrays)}


def _write_npz(path: str, paths, arrays, step, extra):
    """Atomic tmp + rename .npz write of host arrays (the filesystem half
    of ``save``; the async writer's thread runs it)."""
    manifest = {
        "format_version": _FORMAT_VERSION,
        "num_leaves": len(arrays),
        "leaf_paths": paths,
        "step": int(step) if step is not None else None,
        "extra": extra or {},
    }
    named = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __manifest__=json.dumps(manifest), **named)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(path: str, state, step: int | None = None, extra: dict | None = None,
         mesh=None):
    """Atomically save a port state to ``path`` (an .npz file). With the
    ``mesh`` of a slab-sharded state every rank calls it and rank 0
    writes the joined state."""
    paths, arrays = _gathered(state, mesh)
    if mesh is None or _root(mesh).rank == 0:
        _write_npz(path, paths, arrays, step, extra)


def load(path: str, template, migrate: dict | None = None, mesh=None):
    """Restore a state saved with ``save`` (or by the JAX package's).

    Args:
        path: the .npz file.
        template: a state of the same engine (e.g. a freshly built initial
            state): it gives the fields, each leaf's dtype and shape, and
            the device the tensors go to.
        migrate: optional {old_leaf_path: fn(array) -> {new_path: array}}
            applied to checkpoint leaves the template no longer has
            (engines declare theirs as ``CHECKPOINT_MIGRATIONS``).
        mesh: the rank's mesh, for a slab-sharded or data-parallel
            template: each sharded leaf of the file is cut into as many
            equal blocks as its mesh has ranks, and the rank keeps its
            own.

    Returns:
        (state, manifest_dict)
    """
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        if manifest["format_version"] not in (1, _FORMAT_VERSION):
            raise ValueError(
                f"checkpoint format {manifest['format_version']} != "
                f"{_FORMAT_VERSION}")
        paths, leaves = _flatten_with_paths(template)
        if manifest["format_version"] == 1 or "leaf_paths" not in manifest:
            # positional v1 layout: require an exact structural match
            if manifest["num_leaves"] != len(leaves):
                raise ValueError(
                    f"v1 checkpoint has {manifest['num_leaves']} leaves, "
                    f"template has {len(leaves)}: engine/state mismatch")
            by_path = {p: data[f"leaf_{i}"] for i, p in enumerate(paths)}
        else:
            by_path = {p: data[f"leaf_{i}"]
                       for i, p in enumerate(manifest["leaf_paths"])}
    if migrate:
        for old, fn in migrate.items():
            if old in by_path and old not in paths:
                by_path.update(fn(by_path.pop(old)))
    for name, over in _sharded_fields(template, mesh).items():
        arr = by_path.get("." + name)
        if arr is None:
            continue
        if arr.shape[0] % over.world:
            raise ValueError(f"leaf .{name}: {arr.shape[0]} rows do not split "
                             f"into {over.world} ranks")
        k = arr.shape[0] // over.world
        by_path["." + name] = arr[over.rank * k:(over.rank + 1) * k]
    # a leaf the template does not know is a rename or another engine's
    # state: refuse rather than mix states
    unknown = sorted(set(by_path) - set(paths))
    if unknown:
        raise ValueError(
            f"checkpoint leaves {unknown} not in the template state "
            f"(paths: {paths}): engine/state mismatch")
    fields = {}
    for p, leaf in zip(paths, leaves):
        name = p[1:]
        if p not in by_path:
            # a field added to the engine state after this checkpoint was
            # written: the template's value
            print(f"checkpoint: leaf {p} absent in {path}; using the "
                  "template value", file=sys.stderr)
            fields[name] = leaf
            continue
        arr = by_path[p]
        want = np.asarray(leaf) if name == "rng" else leaf
        want_dtype = (want.dtype if name == "rng"
                      else torch.empty((), dtype=leaf.dtype).numpy().dtype)
        if arr.shape != tuple(want.shape) or arr.dtype != want_dtype:
            raise ValueError(
                f"leaf {p}: checkpoint {arr.shape}/{arr.dtype} vs "
                f"template {tuple(want.shape)}/{want_dtype}")
        fields[name] = (tuple(int(w) for w in arr) if name == "rng" else
                        torch.from_numpy(np.array(arr)).to(leaf.device))
    return type(template)(**fields), manifest


class CheckpointManager:
    """Periodic checkpointing with the reference's cadence semantics
    (``checkpoint_saving=100``, pygcpic.py:1336)."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 prefix: str = "state", async_write: bool = False,
                 extra: dict | None = None, mesh=None):
        """``async_write=True`` moves the npz compression and the write to
        one background thread: ``maybe_save`` copies the leaves to the
        host (the only device-synchronous part) and returns while the
        previous checkpoint may still be written. At most one write is in
        flight (the next save waits for it, which keeps the order and
        bounds the extra host memory to one state); a writer's error is
        raised on the next save, ``wait()`` or ``restore``, never lost.
        The write stays atomic. ``extra`` goes into every manifest as it
        is (run provenance). ``mesh``: a slab-sharded state's mesh, as in
        ``save`` and ``load``: every rank calls ``maybe_save`` and
        ``restore``; rank 0 writes and prunes."""
        self.directory = directory
        self.mesh = mesh
        self._writer = mesh is None or _root(mesh).rank == 0
        self.extra = extra
        self.every = int(every)
        self.keep = int(keep)
        self.prefix = prefix
        self._last_saved = 0
        self._executor = None
        self._pending = None
        self._pending_prev_saved = 0
        if async_write:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pypic-ckpt")
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:010d}.npz")

    def maybe_save(self, state, step: int) -> bool:
        """Save when ``step`` crosses an ``every`` boundary since the last
        save: right for a call every step and for strided callers (the
        hybrid BCA driver advances pic_steps_per_bca steps a call, so
        exact multiples may never be hit)."""
        if step // self.every <= self._last_saved // self.every:
            return False
        if self._executor is None:
            save(self._path(step), state, step=step, extra=self.extra,
                 mesh=self.mesh)
            self._last_saved = step
            if self._writer:
                self._gc()
            return True
        # async: finish (and error-check) the previous write, copy the
        # leaves to the host, hand the write and gc to the worker
        self.wait()
        paths, arrays = _gathered(state, self.mesh)
        path = self._path(step)
        if not self._writer:
            self._last_saved = step
            return True

        def _task():
            _write_npz(path, paths, arrays, step, self.extra)
            self._gc()

        self._pending = self._executor.submit(_task)
        self._pending_prev_saved = self._last_saved
        self._last_saved = step
        return True

    def wait(self):
        """Block until the write in flight (if any) is done; re-raise its
        error. On a failure the cadence rolls back, so the failed window
        is saved at the next boundary rather than skipped."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            try:
                pending.result()
            except BaseException:
                self._last_saved = self._pending_prev_saved
                raise

    def close(self):
        """Drain the writer and shut it down (call at the end of a run)."""
        self.wait()
        if self._executor is not None:
            self._executor.shutdown(wait=True)

    def _gc(self):
        ckpts = self.steps()
        for s in ckpts[: -self.keep] if self.keep > 0 else []:
            os.unlink(self._path(s))

    def steps(self):
        out = []
        for f in os.listdir(self.directory):
            if f.startswith(self.prefix + "_") and f.endswith(".npz"):
                out.append(int(f[len(self.prefix) + 1: -4]))
        return sorted(out)

    def latest(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None,
                migrate: dict | None = None):
        self.wait()  # the write in flight may be the checkpoint asked for
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load(self._path(step), template, migrate=migrate,
                    mesh=self.mesh)
