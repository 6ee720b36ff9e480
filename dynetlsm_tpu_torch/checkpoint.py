"""Sampler-state checkpointing (counterpart of ``dynetlsm_tpu/checkpoint.py``).

The sampling stage of a fit persists its chain-batched state (every field
of :class:`~.mcmc.states.LSMState` or :class:`~.mcmc.states.MixtureState`),
the ``torch.Generator``'s state and every trace chunk after each chunk, so
a killed fit resumes where it stopped and draws what the uninterrupted fit
would have drawn (``mcmc.driver.collect_traces``).

All writes are atomic (temp file + ``os.replace``): a crash mid-write, the
event checkpointing protects against, never destroys the previous good
copy.

Layout of a checkpoint directory (the JAX package's)::

    meta.json          {"n_done": int, "n_samples": int, "chunk": int,
                        "fingerprint": str}
    state.npz          the state's fields by name, and the generator state
    chunk_00000.npz    the traces of the first chunk, by name
    ...

Files are written with ``np.savez`` and read with ``allow_pickle=False``.
A JAX checkpoint cannot be resumed: its PRNG keys have no torch
counterpart, and its fingerprint (leaf shapes without names, no generator)
never matches, so the directory is cleared as on any mismatch.
"""
import glob
import json
import os

import numpy as np
import torch

from .mcmc.states import state_from_numpy, state_to_numpy

# the generator's bytes in state.npz (no state field has this name)
GENERATOR = '__generator__'


def _atomic_write(path, write_fn):
    """Write via a same-directory temp file and ``os.replace`` so the
    destination is always either the old or the complete new content."""
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        write_fn(f)
    os.replace(tmp, path)


def _state_arrays(state):
    """The state's fields as NumPy arrays keyed by name, ``None`` fields
    left out, each in its own dtype (integers as int64)."""
    return state_to_numpy(state, int_dtype=np.int64)


def state_fingerprint(state, gen):
    """Structural fingerprint of a state and its generator: each field's
    name, shape and dtype, then the generator's device type and state
    length.  Stored in meta.json, so a resume against another sampler
    configuration (chains, model, dimensions, optional fields) or a
    generator of another device type (whose stream differs) starts
    fresh instead of splicing incompatible runs."""
    parts = ['%s:%s:%s' % (name, tuple(a.shape), a.dtype)
             for name, a in _state_arrays(state).items()]
    parts.append('generator:%s:%d' % (gen.device.type,
                                      gen.get_state().numel()))
    return '|'.join(parts)


def save_state(path, state, gen):
    """Persist a state and its generator's state to ``path`` (.npz),
    atomically."""
    arrays = _state_arrays(state)
    arrays[GENERATOR] = gen.get_state().numpy()
    _atomic_write(path, lambda f: np.savez(f, **arrays))


def load_state(path, device):
    """The state saved at ``path`` on ``device``
    (``states.state_from_numpy``: each field as the sampler holds it,
    ``None`` where it was not saved) and the generator's state (a uint8
    tensor for ``torch.Generator.set_state`` on a generator of the saving
    one's device type)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    gen_state = torch.from_numpy(arrays.pop(GENERATOR))
    return state_from_numpy(arrays, device), gen_state


def save_traces_chunk(directory, index, traces):
    """Persist one chunk's traces (a dict of NumPy arrays), atomically."""
    _atomic_write(os.path.join(directory, 'chunk_%05d.npz' % index),
                  lambda f: np.savez(f, **traces))


def load_traces_chunks(directory, n_chunks):
    """Load exactly the first ``n_chunks`` persisted trace chunks (the ones
    the meta accounts for: files beyond that may be stale leftovers of an
    earlier run in the same directory), each a dict of NumPy arrays."""
    chunks = []
    for idx in range(n_chunks):
        path = os.path.join(directory, 'chunk_%05d.npz' % idx)
        with np.load(path, allow_pickle=False) as data:
            chunks.append({k: data[k] for k in data.files})
    return chunks


def clear_checkpoint(directory):
    """Remove meta/state/chunk files ahead of a fresh run so stale chunks
    of a previous (incompatible) run cannot be spliced into its traces."""
    for path in ([os.path.join(directory, 'meta.json'),
                  os.path.join(directory, 'state.npz')]
                 + glob.glob(os.path.join(directory, 'chunk_*.npz'))):
        if os.path.exists(path):
            os.remove(path)


def read_meta(directory):
    """The directory's meta as a dict, or None without one (a torn meta
    counts as none)."""
    path = os.path.join(directory, 'meta.json')
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None


def write_meta(directory, meta):
    _atomic_write(os.path.join(directory, 'meta.json'),
                  lambda f: f.write(json.dumps(meta).encode()))
