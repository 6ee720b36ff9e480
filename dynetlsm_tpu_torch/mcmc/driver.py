"""Chain driver on one device (counterpart of ``replicate_state``,
``make_scan_runner`` and ``collect_traces`` in
``dynetlsm_tpu/mcmc/driver.py``).

Chains are the leading axis of every state tensor, so one sweep call
advances all of them.  The runner is a Python loop over sweeps that writes
the traced values into a buffer on the device, one row every ``thin``
sweeps, at most ``chunk`` rows a call; ``collect_traces`` copies each
chunk to the host.
"""
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


def collect_traces(runner, state, gen, n_samples, chunk=512, progress=None):
    """Record ``n_samples`` samples in chunks, copying each chunk's traces
    to host memory (the copy is the only wait on the device) and calling
    ``progress(done, n_samples)`` after each.  Returns (final_state,
    traces) with traces a dict of NumPy arrays, sample axis first."""
    if getattr(runner, 'chunk', chunk) != chunk:
        raise ValueError('collect_traces chunk=%d does not match the '
                         "runner's trace buffer (%d)"
                         % (chunk, runner.chunk))
    chunks = []
    done = 0
    while done < n_samples:
        step_n = min(chunk, n_samples - done)
        state, ys = runner(state, gen, step_n)
        chunks.append({k: v.cpu().numpy() for k, v in ys.items()})
        done += step_n
        if progress is not None:
            progress(done, n_samples)
    if not chunks:
        _, ys = runner(state, gen, 0)
        return state, {k: v.cpu().numpy() for k, v in ys.items()}
    return state, {k: np.concatenate([c[k] for c in chunks], axis=0)
                   for k in chunks[0]}
