"""The port's entry points and sweep factories run on the card unless the
caller asks for the CPU: their ``device`` defaults to ``'cuda'``, and
without a CUDA device they raise instead of falling back."""
import inspect

import numpy as np
import pytest
import torch

from dynetlsm_tpu_torch import entry as entry_mod
from dynetlsm_tpu_torch.config import resolve_device
from dynetlsm_tpu_torch.datasets import load_dynamic_monks
from dynetlsm_tpu_torch.mcmc import sweeps

FACTORIES = {
    'entry': entry_mod.entry,
    'build_state_and_sweep': entry_mod.build_state_and_sweep,
    'make_hdp_sweep': sweeps.make_hdp_sweep,
    'make_lpcm_sweep': sweeps.make_lpcm_sweep,
    'make_lsm_sweep': sweeps.make_lsm_sweep,
}


@pytest.mark.parametrize('name', sorted(FACTORIES))
def test_device_defaults_to_cuda(name):
    param = inspect.signature(FACTORIES[name]).parameters['device']
    assert param.default == 'cuda'


@pytest.mark.parametrize('model', ['hdp', 'lpcm', 'lsm'])
def test_build_without_device_uses_the_card_or_raises(model):
    """With CUDA absent, building without a device raises; with a card,
    the state lands on it."""
    Y = load_dynamic_monks()
    if torch.cuda.is_available():
        state, _, gen = entry_mod.build_state_and_sweep(Y, 2, K=3,
                                                        model=model)
        assert state.X.is_cuda and gen.device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry_mod.build_state_and_sweep(Y, 2, K=3, model=model)
    cfg = sweeps.SweepConfig(n_components=3)
    factory = getattr(sweeps, 'make_%s_sweep' % model)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        factory(Y, np.zeros(1, np.float32), cfg)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        entry_mod.entry()


@pytest.mark.parametrize('model', ['hdp', 'lpcm', 'lsm'])
def test_build_on_cpu_when_asked(model):
    state, sweep, gen = entry_mod.build_state_and_sweep(
        load_dynamic_monks(), 2, K=3, device='cpu', model=model)
    assert state.X.device.type == 'cpu' and gen.device.type == 'cpu'
    state = sweep(state, gen)
    assert int(state.it[0]) == 1 and bool(state.logp.isfinite().all())


@pytest.mark.parametrize('model, directed', [
    ('hdp', False), ('lpcm', False), ('lsm', True)])
def test_build_tempered_on_cpu_when_asked(model, directed):
    """``n_temps`` builds bench.py's tempered path: 2 ladders of 4 rungs
    from 1 to ``beta_min``, zero swap counters, and a PT step that runs the
    tempered sweep and a swap without moving the ladder."""
    from dynetlsm_tpu_torch.mcmc.tempering import temper_ladder
    state, step, gen = entry_mod.build_state_and_sweep(
        load_dynamic_monks(is_directed=directed), 8, K=3, device='cpu',
        is_directed=directed, model=model, n_temps=4, beta_min=0.3)
    ladder = temper_ladder(4, 0.3, 2)
    assert torch.equal(state.temper, ladder)
    assert torch.equal(state.acc_swap, torch.zeros(8))
    assert step.n_temps == 4 and step.cfg.is_directed == directed
    assert step.Y.dtype == torch.uint8 and step.Y.device.type == 'cpu'
    for _ in range(3):
        state = step(state, gen)
    assert (state.it == 3).all() and bool(state.logp.isfinite().all())
    assert torch.equal(state.temper, ladder)
    assert ((state.acc_swap >= 0) & (state.acc_swap <= 2)).all()


def test_build_tempered_needs_whole_ladders():
    with pytest.raises(ValueError, match='whole number'):
        entry_mod.build_state_and_sweep(load_dynamic_monks(), 6, K=3,
                                        device='cpu', n_temps=4)


def test_resolve_device_and_unknown_model():
    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError, match='model'):
        entry_mod.build_state_and_sweep(load_dynamic_monks(), 2,
                                        device='cpu', model='sbm')
