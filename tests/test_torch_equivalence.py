"""The JAX suite's slow posterior-equivalence tests, on the port's
estimators at their full budgets: the undirected Sampson LSM and HDP-LPCM
(``tests/test_equivalence_sampson.py:57-90``), the directed Sampson LSM
(``tests/test_equivalence_directed.py:60-65``) and the LPCM on the
simulated community network (``tests/test_equivalence_lpcm.py:32-51``),
against the reference sampler's numbers that
``dynetlsm_tpu_torch/equivalence.py`` holds (``REF_*``, with their source
lines; ``chip_smoke.py`` phase 13 runs the fast budgets).  The slow tests'
budget a chain runs on 4 chains (``BUDGETS`` says why).

They need the card (the port's sweeps on the CPU would take tens of
minutes) and skip without one.  The file imports neither jax nor the JAX
package, so on the card it runs without the suite's conftest:

    python3 -m pytest --noconftest -m cuda tests/test_torch_equivalence.py
"""
import pytest
import torch

from dynetlsm_tpu_torch import equivalence


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the full-budget fits run on the '
                    'card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(equivalence.BUDGETS))
def test_posterior_matches_reference_at_full_budget(card, name):
    est, Y, z_true = equivalence.make_fit(name, card, fast=False)
    est.fit(Y)
    ok, stats, ref = equivalence.posterior_stats(name, est, False, z_true)
    assert ok, '%s (full budget): %s against the reference %s' % (
        name, stats, ref)
