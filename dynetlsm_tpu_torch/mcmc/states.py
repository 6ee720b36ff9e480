"""Sampler states (counterparts of ``LSMState`` and ``MixtureState`` in
``dynetlsm_tpu/mcmc/states.py``), for a dense network with no
case-control, untempered or under parallel tempering.

Every tensor carries the chain axis as its leading dimension; the JAX
package vmaps a single-chain state instead.  The PRNG key of the JAX state
has no field here: a ``torch.Generator`` is passed to each sweep.

* :class:`LSMState`: the dynamic LSM (random-walk prior), with its MAP and
  Procrustes-reference tracking.
* :class:`MixtureState`: the LPCM and the sticky HDP-LPCM.  The HDP
  fields (``weights``, ``beta`` and the concentrations) are ``None`` in an
  LPCM state, whose transitions are ``init_weights`` and
  ``trans_weights``; the LPCM fields are ``None`` in an HDP state.

The directed social-radii model adds ``radii``, ``step_radii`` and
``acc_radii`` and carries two intercepts (b_in, b_out); an undirected state
has one intercept and ``None`` in the radii fields.

Missing-dyad resampling (``SweepConfig.sample_missing``) adds ``Y``, each
chain's network with its missing dyads at their current draws (uint8 0/1,
the observed dyads the same in every chain), and ``missing_sum``, each
missing dyad's sum of draws after burn-in (float32, zero off the missing
mask); both are ``None`` when no dyad is missing, and the sweeps then read
the network they were built with.

Parallel tempering (``mcmc/tempering.py``) adds ``temper``, each slot's
inverse temperature of the network likelihood, and ``acc_swap``, the
accepted replica swaps of the pair (slot, slot + 1); both are ``None`` in
an untempered state.

``state_from_numpy`` / ``state_to_numpy`` carry a state across the two
implementations as a dict of NumPy arrays keyed by the JAX field names, so
tests can hand both samplers the same state.
"""
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DTYPE, ITYPE


@dataclasses.dataclass
class _State:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class LSMState(_State):
    it: torch.Tensor            # (C,) int64 sweep counter
    X: torch.Tensor             # (C, T, n, d) latent positions
    intercept: torch.Tensor     # (C, 1), or (C, 2) = (b_in, b_out) directed
    step_X: torch.Tensor        # (C, T, n)
    acc_X: torch.Tensor         # (C, T, n)
    step_int: torch.Tensor      # (C, 1) or (C, 2)
    acc_int: torch.Tensor       # (C, 1) or (C, 2)
    logp: torch.Tensor          # (C,)
    logp_map: torch.Tensor      # (C,) best logp so far (reset at tune end)
    X_map: torch.Tensor         # (C, T, n, d)
    intercept_map: torch.Tensor  # (C, 1) or (C, 2)
    logp_ref: torch.Tensor      # (C,) best logp up to the end of burn-in
    X_ref: torch.Tensor         # (C, T, n, d) the Procrustes reference
    radii: Optional[torch.Tensor] = None       # (C, n), directed only
    step_radii: Optional[torch.Tensor] = None  # (C,)
    acc_radii: Optional[torch.Tensor] = None   # (C,)
    radii_map: Optional[torch.Tensor] = None   # (C, n)
    # missing-dyad resampling only
    Y: Optional[torch.Tensor] = None           # (C, T, n, n) uint8 0/1
    missing_sum: Optional[torch.Tensor] = None  # (C, T, n, n) float32
    # parallel tempering only
    temper: Optional[torch.Tensor] = None      # (C,) inverse temperatures
    acc_swap: Optional[torch.Tensor] = None    # (C,) swaps of (c, c + 1)


@dataclasses.dataclass
class MixtureState(_State):
    it: torch.Tensor            # (C,) int64 sweep counter
    X: torch.Tensor             # (C, T, n, d) latent positions
    intercept: torch.Tensor     # (C, 1), or (C, 2) = (b_in, b_out) directed
    z: torch.Tensor             # (C, T, n) int64 labels
    mu: torch.Tensor            # (C, K, d)
    sigma: torch.Tensor         # (C, K)
    lmbda: torch.Tensor         # (C,)
    mean_var: torch.Tensor      # (C,)
    b_scale: torch.Tensor       # (C,)
    step_X: torch.Tensor        # (C, T, n)
    acc_X: torch.Tensor         # (C, T, n)
    step_int: torch.Tensor      # (C, 1) or (C, 2)
    acc_int: torch.Tensor       # (C, 1) or (C, 2)
    logp: torch.Tensor          # (C,)
    # HDP only
    weights: Optional[torch.Tensor] = None     # (C, T, K, K), [:, 0, 0] w0
    beta: Optional[torch.Tensor] = None        # (C, K)
    gamma: Optional[torch.Tensor] = None       # (C,)
    alpha_init: Optional[torch.Tensor] = None  # (C,)
    alpha: Optional[torch.Tensor] = None       # (C,)
    kappa: Optional[torch.Tensor] = None       # (C,)
    # LPCM only
    init_weights: Optional[torch.Tensor] = None   # (C, K)
    trans_weights: Optional[torch.Tensor] = None  # (C, K, K)
    # directed only
    radii: Optional[torch.Tensor] = None       # (C, n)
    step_radii: Optional[torch.Tensor] = None  # (C,)
    acc_radii: Optional[torch.Tensor] = None   # (C,)
    # missing-dyad resampling only
    Y: Optional[torch.Tensor] = None           # (C, T, n, n) uint8 0/1
    missing_sum: Optional[torch.Tensor] = None  # (C, T, n, n) float32
    # parallel tempering only
    temper: Optional[torch.Tensor] = None      # (C,) inverse temperatures
    acc_swap: Optional[torch.Tensor] = None    # (C,) swaps of (c, c + 1)


_INT_FIELDS = ('it', 'z')


def state_class(arrays):
    """The state class a dict of fields describes: an LSM state has a
    Procrustes reference ``X_ref``, a mixture state does not."""
    return LSMState if arrays.get('X_ref') is not None else MixtureState


def state_from_numpy(arrays, device):
    """Build an :class:`LSMState` or a :class:`MixtureState` (by
    :func:`state_class`) from a dict of chain-batched NumPy arrays keyed by
    field name (extra keys, such as the JAX state's ``key``, are ignored; a
    missing or ``None`` optional field stays ``None``).  Integer fields are
    cast to int64, the network ``Y`` to uint8, float fields to float32."""
    cls = state_class(arrays)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if arrays.get(f.name) is None:
            continue
        a = np.asarray(arrays[f.name])
        dtype = (ITYPE if f.name in _INT_FIELDS else
                 torch.uint8 if f.name == 'Y' else DTYPE)
        kwargs[f.name] = torch.tensor(a, device=device).to(dtype)
    return cls(**kwargs)


def state_to_numpy(state, int_dtype=np.int32):
    """Dict of NumPy arrays keyed by field name, ``None`` fields left out;
    integer fields are cast to ``int_dtype`` (int32, the JAX package's
    label dtype, by default); the network ``Y`` stays uint8."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        a = v.detach().cpu().numpy()
        out[f.name] = a.astype(int_dtype) if f.name in _INT_FIELDS else a
    return out
