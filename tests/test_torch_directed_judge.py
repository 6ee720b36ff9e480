"""One directed exact sweep of the port on the CPU at Sampson's size (T=3,
n=18, 8 chains, a seeded directed network, a random start), judged by the
benchmark's plain float64 reference of the directed HDP-LPCM
(``port_bench/reference/hdp_directed.py``) under the limits of its cell,
``hdp_ns_directed``: the program comes out inside them, the TF32 control
and each fault the judge plants in the program's place outside them."""
import time

import pytest
import torch

from port_bench import core

CASES = [('program', False, None), ('control', True, None),
         ('intercepts_swapped', False, 'intercepts_swapped'),
         ('network_transposed', False, 'network_transposed'),
         ('radii_prior_dropped', False, 'radii_prior_dropped'),
         ('mixture_unchanged', False, 'mixture_unchanged'),
         ('generator_not_advanced', False, 'generator_not_advanced')]


def _sampson_spec():
    """The cell at T=3, n=18, K=3, 8 chains: two warm-up sweeps and a
    window of two (``--seconds 0`` ends it after one chunk)."""
    spec = core.load_spec('hdp_ns_directed')
    spec['config'] = dict(spec['config'], T=3, n=18, K=3,
                          program=dict(spec['config']['program'], K=3))
    spec['traffic'] = dict(spec['traffic'], chains=8)
    spec['params'] = dict(spec['params'], burn_in=2, chunk=2)
    return spec


@pytest.fixture(scope='module')
def run():
    torch.set_num_threads(1)
    spec = _sampson_spec()
    _, capture = core.measure(spec, 2 ** 33 + 21, 0.0, False,
                              torch.device('cpu'), time.perf_counter())
    return spec, capture


def test_the_run_judged_is_one_directed_exact_sweep(run):
    spec, capture = run
    before, after = capture['before'], capture['after']
    assert capture['Y'].shape == (3, 18, 18)
    assert (capture['Y'] != capture['Y'].transpose(0, 2, 1)).any()
    assert int(before['it'][0]) == 3 and int(after['it'][0]) == 4
    assert before['intercept'].shape == (8, 2) and before['radii'].shape == (
        8, 18)
    # the swap and the transposed network show only where b_in != b_out
    assert bool((after['intercept'][:, 0] != after['intercept'][:, 1]).any())


@pytest.mark.parametrize('name, control, fault', CASES,
                         ids=[c[0] for c in CASES])
def test_the_judge_passes_the_program_and_fails_the_rest(run, name, control,
                                                         fault):
    spec, capture = run
    numbers, failed, _ = core.check_run(spec, capture, torch.device('cpu'),
                                        control=control, fault=fault)
    over = {k: v['value'] for k, v in numbers.items()
            if v['value'] > v['limit']}
    if name == 'program':
        assert failed == 0, numbers
    else:
        assert failed >= 1 and over, numbers
