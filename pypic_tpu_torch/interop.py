"""State carried across packages: ``pypic_tpu`` engine states as dicts of
numpy arrays <-> ``pypic_tpu_torch`` engine states.

The engines have no weights; their state plays their part. With these a
test runs one step in each package from the same state. The round trip
keeps every dtype and is bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .engines.explicit import ExplicitState
from .engines.implicit import ImplicitState

# the fields of pypic_tpu's states (the port's states also cache q and m
# on the host, which they rebuild from q and m)
_FIELDS = ("p", "v", "q", "m", "e", "j", "e_prev", "e_prev2", "step")
_EXPLICIT_FIELDS = ("p", "v", "q", "m", "rho", "e", "step")


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
