"""The port's host datasets, train/test split and network statistics
against the JAX package's, which use scikit-learn, pandas and networkx.

Every generator gets the same arguments and seed in both packages and
must give the same arrays: labels and 0/1 networks exactly, float64
positions and probabilities to rtol 1e-12 (the same draws from the same
``RandomState``; distances in scikit-learn's expanded form).  The loaders
read the same raw files; the split draws the same held-out dyads; the
statistics agree to rtol 1e-12.  And none of the port's modules imports
scikit-learn, pandas, networkx or jax.
"""
import subprocess
import sys

import networkx as nx
import numpy as np
import pytest

import dynetlsm_tpu.datasets as jd
from dynetlsm_tpu import network_statistics as jns
from dynetlsm_tpu.model_selection import train_test_split as jsplit
import dynetlsm_tpu_torch.datasets as pd_
from dynetlsm_tpu_torch import network_statistics as pns
from dynetlsm_tpu_torch.model_selection import train_test_split as psplit


def assert_same(got, want):
    """Equal tuples of arrays and scalars: integer, boolean and 0/1 arrays
    exactly, floats to rtol 1e-12."""
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, k
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype.kind in 'iubUSO' or np.isin(w, (0.0, 1.0)).all():
            np.testing.assert_array_equal(g, w, err_msg=str(k))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0.0,
                                       err_msg=str(k))


SEEDS = [0, 42]


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('directed', [False, True])
def test_network_from_dynamic_latent_space(seed, directed):
    rng = np.random.RandomState(seed + 100)
    X = rng.randn(3, 12, 2)
    kw = dict(intercept=np.array([0.3, 0.7]),
              radii=rng.dirichlet(np.ones(12))) if directed else dict(
                  intercept=0.5, coef=1.5)
    assert_same(pd_.network_from_dynamic_latent_space(X, random_state=seed,
                                                      **kw),
                jd.network_from_dynamic_latent_space(X, random_state=seed,
                                                     **kw))


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('directed', [False, True])
@pytest.mark.parametrize('T', [4, 5])
def test_simple_splitting_dynamic_network(seed, directed, T):
    kw = dict(n_nodes=20, n_time_steps=T, is_directed=directed,
              random_state=seed)
    assert_same(pd_.simple_splitting_dynamic_network(**kw),
                jd.simple_splitting_dynamic_network(**kw))


@pytest.mark.parametrize('seed', SEEDS)
def test_merging_generators(seed):
    kw = dict(n_nodes=20, random_state=seed)
    assert_same(pd_.merging_dynamic_network(**kw),
                jd.merging_dynamic_network(**kw))
    assert_same(pd_.merging_block_model(**kw), jd.merging_block_model(**kw))


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('simulation_type', [None, 'easy', 'hard'])
def test_static_community_network(seed, simulation_type):
    """The port's generator returns the JAX one's first three arrays."""
    kw = dict(n_nodes=20, n_time_steps=4, n_groups=5,
              simulation_type=simulation_type, random_state=seed)
    assert_same(pd_.synthetic_static_community_dynamic_network(**kw),
                jd.synthetic_static_community_dynamic_network(**kw)[:3])


@pytest.mark.parametrize('name, simulation_type, seed', [
    ('homogeneous_simulation', 'easy', 0),
    ('homogeneous_simulation', 'hard', 42),
    ('inhomogeneous_simulation', 'easy', 42),
    ('inhomogeneous_simulation', 'hard', 0)])
def test_simulation_studies(name, simulation_type, seed):
    """Each simulation ends in a 5,000-sample Monte-Carlo forecast."""
    kw = dict(n_nodes=15, simulation_type=simulation_type, random_state=seed)
    if name == 'homogeneous_simulation':
        kw['n_time_steps'] = 3
    assert_same(getattr(pd_, name)(**kw), getattr(jd, name)(**kw))


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('directed, simulation_type',
                         [(False, 'easy'), (False, 'hard'), (True, 'easy')])
def test_synthetic_dynamic_network(seed, directed, simulation_type):
    kw = dict(n_nodes=20, n_time_steps=9, is_directed=directed,
              simulation_type=simulation_type, random_state=seed)
    assert_same(pd_.synthetic_dynamic_network(**kw),
                jd.synthetic_dynamic_network(**kw))


def test_forecast_ground_truths():
    rng = np.random.RandomState(3)
    X, z = rng.randn(10, 2), rng.randint(0, 3, 10)
    wt = rng.dirichlet(np.ones(3), size=3)
    mu, sigma = rng.randn(3, 2), rng.uniform(0.2, 1.0, 3)
    assert_same(pd_.forecast_probas_map(X, z, wt, 0.7, mu, 0.5),
                jd.forecast_probas_map(X, z, wt, 0.7, mu, 0.5))
    kw = dict(n_samples=50, random_state=9)
    assert_same(pd_.forecast_probas(X, z, wt, 0.7, mu, sigma, 0.5, **kw),
                jd.forecast_probas(X, z, wt, 0.7, mu, sigma, 0.5, **kw))


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('r', [0.2, 0.5])
def test_detection_limit(seed, r):
    assert_same(pd_.make_lookup_table(n_samples=500, random_state=seed),
                jd.make_lookup_table(n_samples=500, random_state=seed))
    kw = dict(n_nodes=20, r=r, random_state=seed)
    assert_same(pd_.detection_limit_simulation(**kw),
                jd.detection_limit_simulation(**kw))


@pytest.mark.parametrize('kw', [
    {}, dict(is_directed=False), dict(include_waverers=True),
    dict(encode_labels=False), dict(dynamic=False),
    dict(dynamic=False, is_directed=False, encode_labels=False)])
def test_load_monks(kw):
    assert_same(pd_.load_monks(**kw), jd.load_monks(**kw))


def test_load_dynamic_monks_keeps_its_form():
    """The port's Sampson loader of the earlier slices: the network alone,
    undirected by default."""
    assert_same(pd_.load_dynamic_monks(),
                jd.load_monks(is_directed=False)[0])
    assert_same(pd_.load_dynamic_monks(is_directed=True),
                jd.load_monks()[0])


@pytest.mark.parametrize('kw', [{}, dict(seasons=[1, 2]),
                                dict(weight_min=10),
                                dict(seasons=3, weight_min=5)])
def test_load_got(kw):
    Y, names = pd_.load_got(**kw)
    Yj, names_j = jd.load_got(**kw)
    assert_same(Y, Yj)
    assert names.tolist() == names_j.tolist()


def test_network_from_edgelist():
    edges = np.array([[0, 1], [2, 1], [3, 3], [1, 0]])
    assert_same(pd_.network_from_edgelist(edges, 5),
                jd.network_from_edgelist(edges, 5))


@pytest.mark.parametrize('kw', [{}, dict(min_degree=3),
                                dict(remove_periphery=False)])
def test_load_alliances(kw):
    Y, names = pd_.load_alliances(**kw)
    Yj, names_j = jd.load_alliances(**kw)
    assert_same(Y, Yj)
    assert names.tolist() == names_j.tolist()


def test_load_alliances_refuses_directed():
    for module in (pd_, jd):
        with pytest.raises(NotImplementedError, match='directed'):
            module.load_alliances(directed=True)


@pytest.mark.parametrize('seed', range(4))
def test_core_number_matches_networkx(seed):
    rng = np.random.RandomState(seed)
    A = np.triu(rng.uniform(size=(30, 30)) < 0.05 * (1 + seed), 1)
    A = (A | A.T).astype(float)
    want = nx.core_number(nx.from_numpy_array(A))
    np.testing.assert_array_equal(pd_.core_number(A),
                                  [want[i] for i in range(30)])


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('test_size', [0.1, 0.33, 7])
def test_train_test_split(seed, test_size):
    Y = pd_.load_dynamic_monks()
    assert_same(psplit(Y, test_size=test_size, random_state=seed),
                jsplit(Y, test_size=test_size, random_state=seed))


@pytest.mark.parametrize('directed', [False, True])
def test_network_statistics(directed):
    Y, z = jd.load_monks(is_directed=directed)[:2]
    for fn in ('density', 'num_edges'):
        assert_same(getattr(pns, fn)(Y, is_directed=directed),
                    getattr(jns, fn)(Y, is_directed=directed))
    for Yz in ((Y, z), (Y[0], z[0]), (Y[1], np.array(list('abcab') * 4)[
            :18])):
        assert_same(pns.modularity(*Yz, is_directed=directed),
                    jns.modularity(*Yz, is_directed=directed))
    sparse = np.zeros((6, 6))
    sparse[0, 1] = sparse[1, 0] = sparse[2, 3] = sparse[3, 2] = 1
    for Ys in (sparse, Y[0]):
        for cut in (1, 2):
            assert_same(pns.connected_nodes(Ys, directed, cut),
                        jns.connected_nodes(Ys, directed, cut))


def test_port_host_modules_need_no_sklearn_pandas_networkx_or_jax():
    code = ('import sys\n'
            'import dynetlsm_tpu_torch.datasets as d\n'
            'import dynetlsm_tpu_torch.network_statistics\n'
            'from dynetlsm_tpu_torch.model_selection import '
            'train_test_split\n'
            'd.load_got(); d.load_alliances(); d.load_monks()\n'
            'train_test_split(d.load_dynamic_monks(), random_state=0)\n'
            'bad = [m for m in ("sklearn", "pandas", "networkx", "jax")\n'
            '       if m in sys.modules]\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], check=True)
