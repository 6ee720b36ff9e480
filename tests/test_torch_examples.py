"""The JAX package's examples run against the port on the CPU, from
their unedited sources: ``scripts/run_example.py`` copies each with every
``dynetlsm_tpu`` import swapped for ``dynetlsm_tpu_torch``, and the
estimators get ``device='cpu'`` inside these tests only.  The checks and
budgets are ``tests/test_examples_smoke.py``'s, its ``slow`` marks kept;
``got.py`` and ``military_alliances.py`` run at cut budgets (their
module constants set in the copy), with the mixture fits' nested LSM cut
to 10 + 5 + 5 sweeps, on one intra-op thread (the plain node scan's
small ops run many times faster so).
"""
import importlib.util
import io
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import dynetlsm_tpu_torch as port
from dynetlsm_tpu_torch.models import mixture_base

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    'run_example', os.path.join(ROOT, 'scripts', 'run_example.py'))
run_example = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run_example)

EXAMPLE_NAMES = sorted(f[:-3] for f in os.listdir(run_example.EXAMPLES)
                       if f.endswith('.py'))


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's estimators on the CPU, their mixture fits' nested LSM
    cut to 10 + 5 + 5 sweeps, one intra-op thread."""
    for name, cls in run_example.estimators_on('cpu').items():
        monkeypatch.setattr(port, name, cls)
    init = mixture_base.init_from_lsm

    def short(*args, **kw):
        kw['lsm_kwargs'] = dict(n_iter=10, tune=5, burn=5)
        return init(*args, **kw)
    monkeypatch.setattr(mixture_base, 'init_from_lsm', short)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(name, tmp_path, **constants):
    return run_example.load_port_example(name, constants,
                                         out_dir=str(tmp_path))


@pytest.mark.parametrize('name', EXAMPLE_NAMES)
def test_port_copy_swaps_every_import(name):
    src = run_example.port_source(name)
    assert not re.search(r'\bdynetlsm_tpu\b(?!_torch)', src)
    assert 'dynetlsm_tpu_torch' in src
    compile(src, name, 'exec')
    with open(os.path.join(run_example.EXAMPLES, name + '.py')) as f:
        assert src == f.read().replace('dynetlsm_tpu', 'dynetlsm_tpu_torch')


def test_budget_constants_are_set_in_the_copy():
    src = run_example.port_source('got', dict(N_ITER=20, N_BURN=5))
    assert 'N_ITER, N_TUNE, N_BURN = 20, 5_000, 5' in src
    with pytest.raises(ValueError):
        run_example.port_source('got', dict(NO_SUCH=1))


def test_simulation_scripts_importable(tmp_path):
    hom = load('homogeneous_simulation', tmp_path)
    inhom = load('inhomogeneous_simulation', tmp_path)
    det = load('detection_limit', tmp_path)
    pt = load('parallel_tempering', tmp_path)
    assert callable(hom.benchmark_single)
    assert callable(inhom.benchmark_single)
    assert hasattr(det, '__file__')
    assert callable(pt.run)
    assert pt.make_hard_directed_network(random_state=1).shape == (3, 24, 24)
    assert hom.DynamicNetworkHDPLPCM.__module__.startswith(
        'dynetlsm_tpu_torch')
    from dynetlsm_tpu_torch.datasets import homogeneous_simulation as gen
    Y = gen(n_time_steps=3, n_nodes=30, random_state=1)[0]
    assert Y.shape == (3, 30, 30)


def test_competitor_sbm_smoke(tmp_path):
    sbm = load('competitor_sbm', tmp_path)
    for variant in ('static', 'dynamic'):
        rows, med = sbm.run_study(n_reps=1, sim_type='easy', variant=variant,
                                  n_time_steps=3, n_nodes=60, true_k=6)
        assert -0.5 <= med['rand_index'] <= 1.0
        assert med['vi'] >= 0.0
        assert 2 <= med['num_clusters'] <= 8


@pytest.mark.slow
def test_parallel_tempering_demo(on_cpu, tmp_path):
    b_plain, b_pt, ladder = load('parallel_tempering', tmp_path).run(
        n_iter=400, tune=150, burn=150)
    assert b_plain.shape == (8,) and b_pt.shape == (2,)
    assert np.isfinite(b_plain).all() and np.isfinite(b_pt).all()
    assert b_pt.std() < b_plain.std()
    assert ladder.shape == (8,) and np.allclose(ladder[::4], 1.0)


@pytest.mark.slow
def test_homogeneous_simulation_single_replicate(on_cpu, tmp_path):
    hom = load('homogeneous_simulation', tmp_path)
    out = str(tmp_path / 'benchmark_0.csv')
    res = hom.benchmark_single(n_iter=60, burn=15, tune=15,
                               outfile_name=out, model_type='hdp_lpcm',
                               random_state=0)
    for name in hom.STAT_NAMES:
        assert name in res.columns, name
    row = res.iloc[0]
    assert 0.5 < row['insample_auc'] <= 1.0
    assert 0.5 < row['outsample_auc'] <= 1.0
    assert 0.5 < row['onestep_auc'] <= 1.0
    assert row['vi'] >= 0.0
    assert -1.0 <= row['rand_index'] <= 1.0
    assert os.path.exists(out)


@pytest.mark.parametrize('name, T, n, lines', [
    ('got', 4, 313, ('in-sample AUC:', 'communities per season:',
                     'one-step-ahead forecast shape: (313, 313)')),
    ('military_alliances', 6, None, ('in-sample AUC:', 'communities in 1950',
                                     'communities in 1975'))])
def test_data_example_at_cut_budget(on_cpu, tmp_path, name, T, n, lines):
    """The example's whole script at 20 + 5 + 5 sweeps (two samples at its
    thin of 10): its fit on the real network and its printed report."""
    out = io.StringIO()
    with redirect_stdout(out):
        ex = load(name, tmp_path, N_ITER=20, N_TUNE=5, N_BURN=5)
    m = ex.model
    assert type(m).__module__.startswith('dynetlsm_tpu_torch')
    assert m.Y_fit_.shape[0] == T and (n is None or m.Y_fit_.shape[1] == n)
    assert m.z_.shape == m.Y_fit_.shape[:2]
    assert 0.5 < m.auc_ <= 1.0
    assert np.isfinite(m.logps_).all()
    for line in lines:
        assert line in out.getvalue(), (line, out.getvalue())
