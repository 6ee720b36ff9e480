"""Sampler state of the HDP-LPCM (counterpart of ``MixtureState`` in
``dynetlsm_tpu/mcmc/states.py``, HDP fields only).

Every tensor carries the chain axis as its leading dimension; the JAX
package vmaps a single-chain state instead.  The PRNG key of the JAX state
has no field here: a ``torch.Generator`` is passed to each sweep.

``state_from_numpy`` / ``state_to_numpy`` carry a state across the two
implementations as a dict of NumPy arrays keyed by the JAX field names, so
tests can hand both samplers the same state.

The directed social-radii model adds ``radii``, ``step_radii`` and
``acc_radii`` and carries two intercepts (b_in, b_out); an undirected state
has one intercept and ``None`` in the three radii fields.
"""
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DTYPE, ITYPE


@dataclasses.dataclass
class MixtureState:
    it: torch.Tensor            # (C,) int64 sweep counter
    X: torch.Tensor             # (C, T, n, d) latent positions
    intercept: torch.Tensor     # (C, 1), or (C, 2) = (b_in, b_out) directed
    z: torch.Tensor             # (C, T, n) int64 labels
    mu: torch.Tensor            # (C, K, d)
    sigma: torch.Tensor         # (C, K)
    lmbda: torch.Tensor         # (C,)
    weights: torch.Tensor       # (C, T, K, K); weights[:, 0, 0] initial
    beta: torch.Tensor          # (C, K)
    gamma: torch.Tensor         # (C,)
    alpha_init: torch.Tensor    # (C,)
    alpha: torch.Tensor         # (C,)
    kappa: torch.Tensor         # (C,)
    mean_var: torch.Tensor      # (C,)
    b_scale: torch.Tensor       # (C,)
    step_X: torch.Tensor        # (C, T, n)
    acc_X: torch.Tensor         # (C, T, n)
    step_int: torch.Tensor      # (C, 1) or (C, 2)
    acc_int: torch.Tensor       # (C, 1) or (C, 2)
    logp: torch.Tensor          # (C,)
    radii: Optional[torch.Tensor] = None       # (C, n), directed only
    step_radii: Optional[torch.Tensor] = None  # (C,)
    acc_radii: Optional[torch.Tensor] = None   # (C,)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


_INT_FIELDS = ('it', 'z')


def state_from_numpy(arrays, device):
    """Build a :class:`MixtureState` from a dict of chain-batched NumPy
    arrays keyed by field name (extra keys, such as the JAX state's
    ``key`` or its ``None`` LPCM fields, are ignored; a missing or ``None``
    radii field stays ``None``).  Integer fields are cast to int64, float
    fields to float32."""
    kwargs = {}
    for f in dataclasses.fields(MixtureState):
        if arrays.get(f.name) is None:
            continue
        a = np.asarray(arrays[f.name])
        dtype = ITYPE if f.name in _INT_FIELDS else DTYPE
        kwargs[f.name] = torch.tensor(a, device=device).to(dtype)
    return MixtureState(**kwargs)


def state_to_numpy(state, int_dtype=np.int32):
    """Dict of NumPy arrays keyed by field name, ``None`` fields left out;
    integer fields are cast to ``int_dtype`` (int32, the JAX package's
    label dtype, by default)."""
    out = {}
    for f in dataclasses.fields(MixtureState):
        v = getattr(state, f.name)
        if v is None:
            continue
        a = v.detach().cpu().numpy()
        out[f.name] = a.astype(int_dtype) if f.name in _INT_FIELDS else a
    return out
