"""State carried across packages: ``pypic_tpu`` engine states as dicts of
numpy arrays <-> ``pypic_tpu_torch`` engine states.

The engines have no weights; their state plays their part. With these a
test runs one step in each package from the same state. The round trip
keeps every dtype and is bit-exact.

The domain engines' JAX states hold every shard: (S * capacity,) particle
arrays, shard d's rows at [d cap, (d + 1) cap), and (ng,) slab-sharded
fields, slab d at [d c, (d + 1) c). The port's states are one a rank;
``domain_*_states_from_numpy`` cut the JAX arrays into the S rank states
and ``domain_*_states_to_numpy`` join them again.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engines.explicit import ExplicitState
from .engines.implicit import ImplicitState
from .engines.magnetized import MagnetizedState
from .engines.sheath import SheathState
from .parallel.domain import DomainState
from .parallel.domain_implicit import DomainImplicitState

# the fields of pypic_tpu's states (the port's states also cache q and m
# on the host, which they rebuild from q and m)
_FIELDS = ("p", "v", "q", "m", "e", "j", "e_prev", "e_prev2", "step")
_EXPLICIT_FIELDS = ("p", "v", "q", "m", "rho", "e", "step")
# the tensor fields of the magnetized state (the key words and the host
# step copy are carried apart)
_MAGNETIZED_FIELDS = tuple(f.name for f in dataclasses.fields(MagnetizedState)
                           if f.name not in ("rng", "step_host"))
_SHEATH_FIELDS = tuple(f.name for f in dataclasses.fields(SheathState)
                       if f.name not in ("rng", "step_host"))


def _from_numpy(cls, fields, d: dict, device):
    missing = [k for k in fields if k not in d]
    if missing:
        raise KeyError(f"missing {cls.__name__} fields: {missing}")
    return cls(**{k: torch.from_numpy(np.array(d[k], copy=True)).to(device)
                  for k in fields})


def _to_numpy(state, fields) -> dict:
    return {k: getattr(state, k).detach().cpu().numpy() for k in fields}


def implicit_state_from_numpy(d: dict, device) -> ImplicitState:
    """Build an ImplicitState from a dict of numpy arrays keyed by the
    field names (p, v, q, m, e, j, e_prev, e_prev2, step)."""
    return _from_numpy(ImplicitState, _FIELDS, d, device)


def implicit_state_to_numpy(state: ImplicitState) -> dict:
    """The state's fields as host numpy arrays, dtypes kept."""
    return _to_numpy(state, _FIELDS)


def explicit_state_from_numpy(d: dict, device) -> ExplicitState:
    """Build an ExplicitState from a dict of numpy arrays keyed by the
    field names (p, v, q, m, rho, e, step)."""
    return _from_numpy(ExplicitState, _EXPLICIT_FIELDS, d, device)


def explicit_state_to_numpy(state: ExplicitState) -> dict:
    """The state's fields as host numpy arrays, dtypes kept."""
    return _to_numpy(state, _EXPLICIT_FIELDS)


def _keyed_from_numpy(cls, fields, d: dict, device):
    """A state with the Philox key words and the host step: ``rng``, the
    JAX state's key data (two uint32 words), becomes the port's key words;
    ``step`` is read once into the state's host copy."""
    missing = [k for k in fields + ("rng",) if k not in d]
    if missing:
        raise KeyError(f"missing {cls.__name__} fields: {missing}")
    tensors = {k: torch.from_numpy(np.array(d[k], copy=True)).to(device)
               for k in fields}
    words = np.asarray(d["rng"], np.uint32).reshape(-1)
    return cls(**tensors, rng=(int(words[0]), int(words[-1])),
               step_host=int(np.asarray(d["step"])))


def _keyed_to_numpy(state, fields) -> dict:
    out = _to_numpy(state, fields)
    out["rng"] = np.asarray(state.rng, np.uint32)
    return out


def magnetized_state_from_numpy(d: dict, device) -> MagnetizedState:
    """Build a MagnetizedState from a dict of numpy arrays keyed by the
    JAX state's field names (``rng`` and ``step`` as in
    ``_keyed_from_numpy``)."""
    return _keyed_from_numpy(MagnetizedState, _MAGNETIZED_FIELDS, d, device)


def magnetized_state_to_numpy(state: MagnetizedState) -> dict:
    """The state's fields as host numpy arrays, dtypes kept; ``rng`` as
    two uint32 words."""
    return _keyed_to_numpy(state, _MAGNETIZED_FIELDS)


def sheath_state_from_numpy(d: dict, device) -> SheathState:
    """Build a SheathState from a dict of numpy arrays keyed by the JAX
    state's field names (``rng`` and ``step`` as in
    ``_keyed_from_numpy``)."""
    return _keyed_from_numpy(SheathState, _SHEATH_FIELDS, d, device)


def sheath_state_to_numpy(state: SheathState) -> dict:
    """The state's fields as host numpy arrays, dtypes kept; ``rng`` as
    two uint32 words."""
    return _keyed_to_numpy(state, _SHEATH_FIELDS)


# per-particle fields (cut by capacity), slab fields (cut by cells) and
# replicated scalars of the domain states
_DOMAIN_PARTICLE = ("p", "v", "alive")
_DOMAIN_SCALAR = ("q", "m", "step")
_DOMAIN_SLAB = {DomainState: ("rho",),
                DomainImplicitState: ("e", "j", "e_prev", "e_prev2")}


def _domain_from_numpy(cls, d: dict, num_shards: int, device) -> list:
    slabs = _DOMAIN_SLAB[cls]
    missing = [k for k in _DOMAIN_PARTICLE + _DOMAIN_SCALAR + slabs
               if k not in d]
    if missing:
        raise KeyError(f"missing {cls.__name__} fields: {missing}")

    def cut(a, r):
        a = np.asarray(a)
        if a.shape[0] % num_shards:
            raise ValueError(f"{a.shape[0]} rows do not split into "
                             f"{num_shards} shards")
        k = a.shape[0] // num_shards
        return torch.from_numpy(np.array(a[r * k:(r + 1) * k])).to(device)

    states = []
    for r in range(num_shards):
        kw = {k: cut(d[k], r) for k in _DOMAIN_PARTICLE + slabs}
        kw.update({k: torch.from_numpy(np.array(d[k], copy=True)).to(device)
                   for k in _DOMAIN_SCALAR})
        states.append(cls(**kw))
    return states


def _domain_to_numpy(states) -> dict:
    cls = type(states[0])
    out = {k: np.concatenate([getattr(s, k).detach().cpu().numpy()
                              for s in states])
           for k in _DOMAIN_PARTICLE + _DOMAIN_SLAB[cls]}
    out.update({k: getattr(states[0], k).detach().cpu().numpy()
                for k in _DOMAIN_SCALAR})
    return out


def domain_implicit_states_from_numpy(d: dict, num_shards: int,
                                      device) -> list:
    """The S rank states of a JAX ``DomainImplicitState`` given as a dict
    of numpy arrays (p, v, alive, q, m, e, j, e_prev, e_prev2, step)."""
    return _domain_from_numpy(DomainImplicitState, d, num_shards, device)


def domain_implicit_states_to_numpy(states) -> dict:
    """The rank states joined into the JAX state's global arrays."""
    return _domain_to_numpy(states)


def domain_states_from_numpy(d: dict, num_shards: int, device) -> list:
    """The S rank states of a JAX ``DomainState`` (p, v, alive, q, m,
    step, rho)."""
    return _domain_from_numpy(DomainState, d, num_shards, device)


def domain_states_to_numpy(states) -> dict:
    return _domain_to_numpy(states)
