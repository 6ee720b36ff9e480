"""The per-block profiler of the port's sweep, on the CPU at a tiny size:
every block of the sweep is timed once per sweep, and the sweep module's
functions are restored afterwards."""
import numpy as np
import pytest

from dynetlsm_tpu_torch import profile_blocks
from dynetlsm_tpu_torch.entry import build_state_and_sweep
from dynetlsm_tpu_torch.mcmc import sweeps, tempering


def _tiny_network(directed, T=3, n=10, seed=0):
    rng = np.random.RandomState(seed)
    Y = rng.binomial(1, 0.3, (T, n, n)).astype(np.float64)
    Y[:, np.arange(n), np.arange(n)] = 0
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + Y.transpose(0, 2, 1)
    return Y


@pytest.mark.parametrize('directed, model, n_temps', [
    (False, 'hdp', None), (True, 'hdp', None), (False, 'lsm', None),
    (True, 'lpcm', None), (False, 'hdp', 4), (True, 'lsm', 2)])
def test_profile_slice_times_every_block(directed, model, n_temps):
    state, sweep, gen = build_state_and_sweep(
        _tiny_network(directed), 4, K=3, device='cpu', is_directed=directed,
        model=model, n_temps=n_temps)
    before = {name: getattr(sweeps, name) for name in profile_blocks.BLOCKS}
    swap = tempering.replica_exchange
    out, state = profile_blocks.profile_slice(sweep, state, gen, sweeps=2,
                                              warm=1)
    assert {name: getattr(sweeps, name)
            for name in profile_blocks.BLOCKS} == before
    assert tempering.replica_exchange is swap
    blocks = out['blocks_ms']
    coef = (('sample_intercepts_directed', 'sample_radii') if directed
            else ('sample_intercept_undirected',))
    per_model = {
        'hdp': ('sample_labels_block', 'sample_dirichlet',
                '_hdp_weights_logp', '_mixture_common_logp'),
        'lpcm': ('sample_labels_block_lpcm', 'sample_dirichlet',
                 '_lpcm_weights_logp', '_mixture_common_logp'),
        'lsm': ('longitudinal_procrustes_rotation', '_lsm_logp')}[model]
    swap_block = ('replica_exchange',) if n_temps else ()
    for name in ('sample_latent_positions', '_finish_tuning',
                 'other') + coef + per_model + swap_block:
        assert name in blocks
    assert n_temps or 'replica_exchange' not in blocks
    assert all(v > 0 for k, v in blocks.items() if k != 'other')
    assert sum(blocks.values()) == pytest.approx(out['sweep_synced_ms'])
    assert int(state.it[0]) == 5


@pytest.mark.parametrize('directed, model', [(False, 'hdp'), (True, 'lsm')])
def test_profile_slice_times_the_missing_dyads(directed, model):
    """With dyads coded -1 the resample and the log-likelihood on the new
    network are one block, ``_missing_dyad_step``; without, there is none."""
    Y = _tiny_network(directed)
    Y[0, 1, 2] = Y[0, 2, 1] = -1.0
    state, sweep, gen = build_state_and_sweep(
        Y, 4, K=3, device='cpu', is_directed=directed, model=model)
    out, _ = profile_blocks.profile_slice(sweep, state, gen, sweeps=2,
                                          warm=1)
    assert out['blocks_ms']['_missing_dyad_step'] > 0
    state, sweep, gen = build_state_and_sweep(
        _tiny_network(directed), 4, K=3, device='cpu', is_directed=directed,
        model=model)
    out, _ = profile_blocks.profile_slice(sweep, state, gen, sweeps=2,
                                          warm=1)
    assert '_missing_dyad_step' not in out['blocks_ms']


def test_union_of_kernel_intervals():
    assert profile_blocks._union_us([]) == 0
    assert profile_blocks._union_us([(5, 9), (0, 2), (1, 3), (8, 10)]) == 8
