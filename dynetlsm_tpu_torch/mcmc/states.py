"""Sampler state of the HDP-LPCM (counterpart of ``MixtureState`` in
``dynetlsm_tpu/mcmc/states.py``, HDP fields only).

Every tensor carries the chain axis as its leading dimension; the JAX
package vmaps a single-chain state instead.  The PRNG key of the JAX state
has no field here: a ``torch.Generator`` is passed to each sweep.

``state_from_numpy`` / ``state_to_numpy`` carry a state across the two
implementations as a dict of NumPy arrays keyed by the JAX field names, so
tests can hand both samplers the same state.
"""
import dataclasses

import numpy as np
import torch

from ..config import DTYPE, ITYPE


@dataclasses.dataclass
class MixtureState:
    it: torch.Tensor            # (C,) int64 sweep counter
    X: torch.Tensor             # (C, T, n, d) latent positions
    intercept: torch.Tensor     # (C, 1)
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
    step_int: torch.Tensor      # (C, 1)
    acc_int: torch.Tensor       # (C, 1)
    logp: torch.Tensor          # (C,)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


_INT_FIELDS = ('it', 'z')


def state_from_numpy(arrays, device):
    """Build a :class:`MixtureState` from a dict of chain-batched NumPy
    arrays keyed by field name (extra keys, such as the JAX state's
    ``key`` or its ``None`` LPCM fields, are ignored).  Integer fields are
    cast to int64, float fields to float32."""
    kwargs = {}
    for f in dataclasses.fields(MixtureState):
        a = np.asarray(arrays[f.name])
        dtype = ITYPE if f.name in _INT_FIELDS else DTYPE
        kwargs[f.name] = torch.tensor(a, device=device).to(dtype)
    return MixtureState(**kwargs)


def state_to_numpy(state, int_dtype=np.int32):
    """Dict of NumPy arrays keyed by field name; integer fields are cast to
    ``int_dtype`` (int32, the JAX package's label dtype, by default)."""
    out = {}
    for f in dataclasses.fields(MixtureState):
        a = getattr(state, f.name).detach().cpu().numpy()
        out[f.name] = a.astype(int_dtype) if f.name in _INT_FIELDS else a
    return out
