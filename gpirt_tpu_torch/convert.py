"""Carry parameters between the JAX package and the port as numpy arrays.

``constants_from_numpy`` takes the fields of a ``GPIRTConstants`` (the JAX
package's dataclass, or any object or mapping with those names);
``state_from_numpy`` takes a ``GPIRTState`` with a leading chain axis. Both
copy each field with ``np.array``, so JAX arrays pass without this module
importing JAX. ``to_numpy`` goes back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from gpirt_tpu_torch.models.config import GPIRTConstants
from gpirt_tpu_torch.models.gibbs import GPIRTState

__all__ = ["constants_from_numpy", "state_from_numpy", "to_numpy"]


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def constants_from_numpy(src, *, device, dtype: torch.dtype) -> GPIRTConstants:
    """The optional time-GP fields (None outside the GP regime) stay None."""
    def tensor(a):
        if a is None:
            return None
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return GPIRTConstants(**{f.name: tensor(_field(src, f.name))
                             for f in dataclasses.fields(GPIRTConstants)})


def state_from_numpy(src, *, device, dtype: torch.dtype) -> GPIRTState:
    """Lane-stacked state: theta_idx (K, H, n), f (K, H, n, m), ..."""
    return GPIRTState(**{
        name: torch.as_tensor(
            np.array(_field(src, name)),
            dtype=torch.int64 if name == "theta_idx" else dtype, device=device)
        for name in GPIRTState._fields
    })


def to_numpy(x) -> Dict[str, np.ndarray]:
    """A GPIRTState or GPIRTConstants -> {field: numpy array}."""
    if isinstance(x, GPIRTState):
        items = x._asdict().items()
    else:
        items = ((f.name, getattr(x, f.name)) for f in dataclasses.fields(x))
    return {k: None if v is None else v.detach().cpu().numpy() for k, v in items}
