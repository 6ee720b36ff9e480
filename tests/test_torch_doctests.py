"""The port's estimator docstring examples, run under doctest as
``tests/test_doctests.py`` runs the JAX package's.  They pass
``device='cpu'`` themselves."""
import doctest

import pytest
import torch

import dynetlsm_tpu_torch.models.hdp_lpcm
import dynetlsm_tpu_torch.models.lpcm
import dynetlsm_tpu_torch.models.lsm


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('module', [
    dynetlsm_tpu_torch.models.lsm,
    dynetlsm_tpu_torch.models.lpcm,
    dynetlsm_tpu_torch.models.hdp_lpcm,
], ids=lambda m: m.__name__.rsplit('.', 1)[-1])
def test_estimator_docstring_examples(one_thread, module):
    results = doctest.testmod(module, verbose=False)
    assert results.attempted > 0, 'docstring examples missing'
    assert results.failed == 0
