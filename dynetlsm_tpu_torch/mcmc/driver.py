"""Chain driver on one device (counterpart of ``replicate_state``,
``make_scan_runner`` and ``collect_traces`` in
``dynetlsm_tpu/mcmc/driver.py``).

Chains are the leading axis of every state tensor, so one sweep call
advances all of them.  The runner is a Python loop over sweeps that writes
each sweep's traced values into a preallocated ``chunk``-long buffer on
the device; ``collect_traces`` copies each chunk to the host.
"""
import numpy as np
import torch

from .states import state_from_numpy


def replicate_state(state0, n_chains, device):
    """Broadcast a single-chain state, given as a dict of arrays keyed by
    the field names of :class:`~.states.LSMState` or
    :class:`~.states.MixtureState` (no chain axis; the fields given pick
    the class, :func:`~.states.state_class`), across a new leading chain
    axis of length ``n_chains`` on ``device``; ``None`` fields stay
    ``None``."""
    batched = {k: np.broadcast_to(np.asarray(v), (n_chains,)
                                  + np.shape(v)).copy()
               for k, v in state0.items() if v is not None}
    return state_from_numpy(batched, device)


def make_scan_runner(sweep_fn, trace_fn, chunk=512):
    """A runner ``run(state, gen, n_samples) -> (state, buffers)`` that
    advances ``n_samples`` <= ``chunk`` sweeps and records
    ``trace_fn(state)`` (a dict of tensors) after each into buffers of
    length ``chunk`` (rows past ``n_samples`` are left unwritten)."""

    def run(state, gen, n_samples):
        if n_samples > chunk:
            raise ValueError('n_samples=%d exceeds the runner chunk %d'
                             % (n_samples, chunk))
        sample0 = trace_fn(state)
        buf = {k: torch.empty((chunk,) + tuple(v.shape), dtype=v.dtype,
                              device=v.device)
               for k, v in sample0.items()}
        for i in range(n_samples):
            state = sweep_fn(state, gen)
            for k, v in trace_fn(state).items():
                buf[k][i].copy_(v)
        return state, buf

    run.chunk = chunk
    return run


def collect_traces(runner, state, gen, n_samples, chunk=512):
    """Run ``n_samples`` recorded sweeps in chunks, copying each chunk's
    traces to host memory.  Returns (final_state, traces) with traces a
    dict of NumPy arrays, sample axis first."""
    if getattr(runner, 'chunk', chunk) != chunk:
        raise ValueError('collect_traces chunk=%d does not match the '
                         "runner's trace buffer (%d)"
                         % (chunk, runner.chunk))
    chunks = []
    done = 0
    while done < n_samples:
        step_n = min(chunk, n_samples - done)
        state, ys = runner(state, gen, step_n)
        chunks.append({k: v[:step_n].cpu().numpy() for k, v in ys.items()})
        done += step_n
    if not chunks:
        _, ys = runner(state, gen, 0)
        return state, {k: v[:0].cpu().numpy() for k, v in ys.items()}
    return state, {k: np.concatenate([c[k] for c in chunks], axis=0)
                   for k in chunks[0]}
