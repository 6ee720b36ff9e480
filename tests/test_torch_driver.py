"""The port's chain driver (``dynetlsm_tpu_torch/mcmc/driver.py``) with a
deterministic stub sweep that adds one to a per-chain counter: ``thin=k``
records every k-th state, ``collect_traces`` cuts the samples into chunks
and trims the last, and ``progress`` is called once per chunk."""
import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch.mcmc.driver import collect_traces, make_scan_runner


def _sweep(state, gen):
    return state + 1


def _trace(state):
    return {'it': state, 'sq': state * state}


@pytest.mark.parametrize('thin', [1, 2, 5])
@pytest.mark.parametrize('n_samples, chunk', [(7, 3), (6, 3), (4, 16),
                                              (1, 1)])
def test_thinned_chunked_traces(thin, n_samples, chunk):
    runner = make_scan_runner(_sweep, _trace, chunk=chunk, thin=thin)
    calls = []
    state0 = torch.tensor([0, 100], dtype=torch.int64)
    state, traces = collect_traces(
        runner, state0, None, n_samples, chunk=chunk,
        progress=lambda done, total: calls.append((done, total)))
    # sample i is the state after (i + 1) * thin sweeps
    want = thin * np.arange(1, n_samples + 1)[:, None] + np.array([0, 100])
    np.testing.assert_array_equal(traces['it'], want)
    np.testing.assert_array_equal(traces['sq'], want * want)
    np.testing.assert_array_equal(state.numpy(), want[-1])
    ends = list(range(chunk, n_samples, chunk)) + [n_samples]
    assert calls == [(done, n_samples) for done in ends]


def test_no_samples_gives_empty_traces():
    runner = make_scan_runner(_sweep, _trace, chunk=4, thin=3)
    state0 = torch.zeros(2, dtype=torch.int64)
    state, traces = collect_traces(runner, state0, None, 0, chunk=4)
    assert traces['it'].shape == (0, 2) and state is state0


def test_chunk_mismatch_and_overlong_runs_raise():
    runner = make_scan_runner(_sweep, _trace, chunk=4)
    assert runner.thin == 1
    with pytest.raises(ValueError, match='does not match'):
        collect_traces(runner, torch.zeros(1), None, 3, chunk=8)
    with pytest.raises(ValueError, match='exceeds the runner chunk'):
        runner(torch.zeros(1), None, 5)


def test_runner_buffers_hold_the_samples_recorded():
    """A call's buffers have one row a recorded sample, not ``chunk``."""
    runner = make_scan_runner(_sweep, _trace, chunk=512, thin=2)
    state, buf = runner(torch.zeros(3, dtype=torch.int64), None, 4)
    assert buf['it'].shape == (4, 3)
    np.testing.assert_array_equal(buf['it'][:, 0].numpy(), [2, 4, 6, 8])
