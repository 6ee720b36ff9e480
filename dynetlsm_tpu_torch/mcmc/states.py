"""Sampler states (counterparts of ``LSMState`` and ``MixtureState`` in
``dynetlsm_tpu/mcmc/states.py``), for a dense network or the case-control
likelihood, untempered or under parallel tempering.

Every tensor but the case-control controls carries the chain axis as its
leading dimension; the JAX package vmaps a single-chain state instead.  The PRNG key of the JAX state
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

The case-control likelihood (``SweepConfig.n_control``) adds ``ctrl_in``
and ``ctrl_out``, the control nodes of every node (n, n_control) int64,
-1 where a draw is void: with colour classes one draw shared by every
chain, so these two fields carry no chain axis (``SHARED_FIELDS``,
:func:`is_shared`); without them (the sequential scan's draw, as in JAX)
one draw a chain, (C, n, n_control).  ``ctrl_in`` is ``None`` when
undirected.

Parallel tempering (``mcmc/tempering.py``) adds ``temper``, each slot's
inverse temperature of the network likelihood, and ``acc_swap``, the
accepted replica swaps of the pair (slot, slot + 1); both are ``None`` in
an untempered state.

``state_from_numpy`` / ``state_to_numpy`` carry a state across the two
implementations as a dict of NumPy arrays keyed by the JAX field names, so
tests can hand both samplers the same state.

On a mesh (``mcmc/driver.py``) a fit's state is a list of states, one a
chain row, each on its row's first device; under node sharding the row's
``Y`` and ``missing_sum`` are row-split over its node devices
(``ops.shards.RowShards``, the fields ``NODE_FIELDS``).
:func:`gather_state` joins such a list into one state and
:func:`place_like` lays a state out as another.
"""
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import DTYPE, ITYPE
from ..ops.shards import RowShards


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
    # case-control only: one draw shared by the chains, or (C, n, m)
    ctrl_in: Optional[torch.Tensor] = None     # (n, m) int64, directed
    ctrl_out: Optional[torch.Tensor] = None    # (n, m) int64


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
    # case-control only: one draw shared by the chains, or (C, n, m)
    ctrl_in: Optional[torch.Tensor] = None     # (n, m) int64, directed
    ctrl_out: Optional[torch.Tensor] = None    # (n, m) int64


_INT_FIELDS = ('it', 'z', 'ctrl_in', 'ctrl_out')
# the fields with no chain axis when they hold one draw for all chains
SHARED_FIELDS = ('ctrl_in', 'ctrl_out')


def is_shared(name, v):
    """Whether field ``name`` of value v has no chain axis: the controls
    of a coloured case-control sweep (n, m), not one draw a chain (C, n,
    m)."""
    return name in SHARED_FIELDS and v.dim() == 2


# the fields that node sharding splits by rows (their axis 2 of 4)
NODE_FIELDS = ('Y', 'missing_sum')


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
    label dtype, by default); the network ``Y`` stays uint8.  Row-split
    fields are gathered; a list of row states (a mesh's) is joined first
    (:func:`gather_state`)."""
    if isinstance(state, list):
        state = gather_state(state)
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if isinstance(v, RowShards):
            v = v.gather('cpu')
        a = v.detach().cpu().numpy()
        out[f.name] = a.astype(int_dtype) if f.name in _INT_FIELDS else a
    return out


def gather_state(states, device='cpu'):
    """One chain-batched state on ``device`` from the chain rows' states
    of a mesh (a list; a single state is returned as it is): the chain
    axes joined in row order, row-split fields gathered, the shared fields
    taken from the first row."""
    if not isinstance(states, list):
        return states
    fields = {}
    for f in dataclasses.fields(states[0]):
        vals = [getattr(s, f.name) for s in states]
        if vals[0] is None:
            continue
        if is_shared(f.name, vals[0]):
            fields[f.name] = vals[0].to(device)
            continue
        fields[f.name] = torch.cat(
            [v.gather(device) if isinstance(v, RowShards) else v.to(device)
             for v in vals], dim=0)
    return type(states[0])(**fields)


def place_like(state, like):
    """The chain-batched ``state`` (on any device) laid out as ``like``: a
    single state's fields moved to its devices, or for a mesh's list of
    row states the chains cut into the rows' chain counts, each row on its
    devices; a field row-split in ``like`` is split with its bounds over
    its devices."""
    rows = like if isinstance(like, list) else [like]
    out = []
    c0 = 0
    for row in rows:
        sl = slice(c0, c0 + row.X.shape[0])
        c0 = sl.stop
        fields = {}
        for f in dataclasses.fields(state):
            v, ref = getattr(state, f.name), getattr(row, f.name)
            if v is None:
                continue
            if is_shared(f.name, v):
                fields[f.name] = v.to(ref.device)
            elif isinstance(ref, RowShards):
                fields[f.name] = RowShards.split(v[sl], ref.devices,
                                                 ref.bounds)
            else:
                fields[f.name] = v[sl].to(ref.device)
        out.append(type(row)(**fields))
    return out if isinstance(like, list) else out[0]
