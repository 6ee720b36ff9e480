"""Chain driver on one device (counterpart of ``replicate_state``,
``make_scan_runner`` and ``collect_traces`` in
``dynetlsm_tpu/mcmc/driver.py``).

Chains are the leading axis of every state tensor, so one sweep call
advances all of them.  The runner is a Python loop over sweeps that writes
the traced values into a buffer on the device, one row every ``thin``
sweeps, at most ``chunk`` rows a call; ``collect_traces`` copies each
chunk to the host, and with a ``checkpoint_dir`` persists it with the
state so that an interrupted run resumes.
"""
import os

import numpy as np
import torch

from .states import SHARED_FIELDS, state_from_numpy


def replicate_state(state0, n_chains, device):
    """Broadcast a single-chain state, given as a dict of arrays keyed by
    the field names of :class:`~.states.LSMState` or
    :class:`~.states.MixtureState` (no chain axis; the fields given pick
    the class, :func:`~.states.state_class`), across a new leading chain
    axis of length ``n_chains`` on ``device``; ``None`` fields stay
    ``None``.  Every chain gets its own copy of the network ``Y`` (missing
    dyads resampled), and a zero ``missing_sum`` unless one is given; the
    case-control controls (``states.SHARED_FIELDS``) stay one for all."""
    batched = {k: (np.asarray(v) if k in SHARED_FIELDS else
                   np.broadcast_to(np.asarray(v), (n_chains,)
                                   + np.shape(v)).copy())
               for k, v in state0.items() if v is not None}
    if 'Y' in batched and 'missing_sum' not in batched:
        batched['missing_sum'] = np.zeros(batched['Y'].shape, np.float32)
    return state_from_numpy(batched, device)


def make_scan_runner(sweep_fn, trace_fn, chunk=512, thin=1):
    """A runner ``run(state, gen, n_samples) -> (state, buffers)`` that
    records ``n_samples`` <= ``chunk`` samples, each after ``thin`` more
    sweeps (thinning on the device: the sweeps between two samples are
    never recorded), writing ``trace_fn(state)`` (a dict of tensors) into
    buffers of ``n_samples`` rows on the device.  Nothing in it waits on
    the device."""

    def run(state, gen, n_samples):
        if n_samples > chunk:
            raise ValueError('n_samples=%d exceeds the runner chunk %d'
                             % (n_samples, chunk))
        sample0 = trace_fn(state)
        buf = {k: torch.empty((n_samples,) + tuple(v.shape),
                              dtype=v.dtype, device=v.device)
               for k, v in sample0.items()}
        for i in range(n_samples):
            for _ in range(thin):
                state = sweep_fn(state, gen)
            for k, v in trace_fn(state).items():
                buf[k][i].copy_(v)
        return state, buf

    run.chunk = chunk
    run.thin = thin
    return run


def collect_traces(runner, state, gen, n_samples, chunk=512, progress=None,
                   checkpoint_dir=None):
    """Record ``n_samples`` samples in chunks, copying each chunk's traces
    to host memory (the copy is the only wait on the device) and calling
    ``progress(done, n_samples)`` after each.  Returns (final_state,
    traces) with traces a dict of NumPy arrays, sample axis first.

    With ``checkpoint_dir`` (JAX ``collect_traces``'s policy) the chunk's
    traces, then the state with the generator's state, then the meta are
    written after each chunk (``dynetlsm_tpu_torch/checkpoint.py``), so a
    crash between two writes leaves the previous good meta; ``progress``
    runs after the meta.  A run resumes from the last completed chunk when
    the meta's ``n_samples`` and ``chunk`` and the fingerprint of the state
    and generator (``checkpoint.state_fingerprint``) match and ``n_done >
    0``: the state and the generator's state are restored (``gen``
    itself, so the caller's generator goes on from there) and the first
    ``ceil(n_done / chunk)`` chunks are read back.  Otherwise the directory
    is cleared and the run starts fresh.  The generator's state is taken
    after the chunk's sweeps are issued: a CUDA generator advances its
    offset when a kernel is launched, not when it finishes."""
    from ..checkpoint import (
        clear_checkpoint, load_state, load_traces_chunks, read_meta,
        save_state, save_traces_chunk, state_fingerprint, write_meta)
    if getattr(runner, 'chunk', chunk) != chunk:
        raise ValueError('collect_traces chunk=%d does not match the '
                         "runner's trace buffer (%d)"
                         % (chunk, runner.chunk))
    chunks = []
    done = 0
    if checkpoint_dir is not None and n_samples > 0:
        os.makedirs(checkpoint_dir, exist_ok=True)
        state_path = os.path.join(checkpoint_dir, 'state.npz')
        meta = read_meta(checkpoint_dir)
        fingerprint = state_fingerprint(state, gen)
        if meta is not None and meta.get('n_samples') == n_samples \
                and meta.get('chunk') == chunk and meta.get('n_done', 0) > 0 \
                and meta.get('fingerprint') == fingerprint:
            state, gen_state = load_state(state_path, state.X.device)
            gen.set_state(gen_state)
            done = meta['n_done']
            chunks = load_traces_chunks(checkpoint_dir, -(-done // chunk))
        else:
            clear_checkpoint(checkpoint_dir)
    while done < n_samples:
        step_n = min(chunk, n_samples - done)
        state, ys = runner(state, gen, step_n)
        host_chunk = {k: v.cpu().numpy() for k, v in ys.items()}
        if checkpoint_dir is not None:
            save_traces_chunk(checkpoint_dir, len(chunks), host_chunk)
            save_state(state_path, state, gen)
        chunks.append(host_chunk)
        done += step_n
        if checkpoint_dir is not None:
            write_meta(checkpoint_dir,
                       {'n_done': done, 'n_samples': n_samples,
                        'chunk': chunk, 'fingerprint': fingerprint})
        if progress is not None:
            progress(done, n_samples)
    if not chunks:
        _, ys = runner(state, gen, 0)
        return state, {k: v.cpu().numpy() for k, v in ys.items()}
    return state, {k: np.concatenate([c[k] for c in chunks], axis=0)
                   for k in chunks[0]}
