"""The port's plotting layer (``dynetlsm_tpu_torch/plots.py``,
``text_utils.py``) on the Agg backend: the counterparts of the JAX
package's ``tests/test_plots.py`` on port fits, and JAX's and the port's
plot functions on one stub model carrying the same arrays, drawing the
same data (lines, images, patches, collections, texts) within 1e-12.
"""
import types

import numpy as np
import pytest

matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from dynetlsm_tpu import plots as jax_plots  # noqa: E402
from dynetlsm_tpu import text_utils as jax_text  # noqa: E402
from dynetlsm_tpu_torch import (  # noqa: E402
    DynamicNetworkHDPLPCM, DynamicNetworkLPCM, DynamicNetworkLSM, plots,
    text_utils)
from dynetlsm_tpu_torch.datasets import (  # noqa: E402
    synthetic_static_community_dynamic_network)
from dynetlsm_tpu_torch.models import mixture_base  # noqa: E402

# the mixture fits' nested LSM, cut as the other estimator tests cut it
NESTED = dict(n_iter=20, tune=10, burn=10)


@pytest.fixture(scope='module')
def short_nested():
    with pytest.MonkeyPatch.context() as mp:
        init = mixture_base.init_from_lsm

        def short(*args, **kw):
            kw['lsm_kwargs'] = NESTED
            return init(*args, **kw)
        mp.setattr(mixture_base, 'init_from_lsm', short)
        yield


@pytest.fixture(scope='module')
def fitted_models(short_nested):
    Y, X, z = synthetic_static_community_dynamic_network(
        n_nodes=25, n_time_steps=2, n_groups=3, simulation_type='easy',
        random_state=42)
    lsm = DynamicNetworkLSM(n_iter=30, tune=30, burn=30, random_state=1,
                            device='cpu').fit(Y)
    lpcm = DynamicNetworkLPCM(n_iter=30, tune=30, burn=30, n_components=3,
                              random_state=1, device='cpu').fit(Y)
    return Y, z, lsm, lpcm


def test_plot_traces(fitted_models):
    _, _, lsm, lpcm = fitted_models
    fig, axes = plots.plot_traces(lsm)
    assert axes.shape[1] == 3
    plt.close(fig)
    fig, axes = plots.plot_traces(lpcm)
    assert axes.shape[1] == 3
    plt.close(fig)


def test_kde_curve_integrates_to_one():
    rng = np.random.RandomState(0)
    grid, dens = plots._kde_curve(rng.randn(500))
    assert abs(np.trapezoid(dens, grid) - 1.0) < 1e-2
    grid, dens = plots._kde_curve(np.full(10, 3.0))
    assert np.isfinite(dens).all()


def test_plot_latent_space(fitted_models):
    _, _, lsm, lpcm = fitted_models
    fig, ax = plots.plot_latent_space(lsm, t=0)
    plt.close(fig)
    fig, ax = plots.plot_latent_space(lpcm, t=1, node_names=[
        'n%d' % i for i in range(lpcm.X_.shape[1])])
    plt.close(fig)


def test_matrix_plots(fitted_models):
    Y, z, _, lpcm = fitted_models
    fig, _ = plots.plot_adjacency_matrix(Y[0], z[0])
    plt.close(fig)
    fig, _ = plots.plot_probability_matrix(lpcm.probas_[0], lpcm.z_[0])
    plt.close(fig)
    fig, _ = plots.plot_posterior_cooccurrence(lpcm, t=0)
    plt.close(fig)


def test_transition_and_alluvial(fitted_models):
    _, z, _, lpcm = fitted_models
    fig, _ = plots.plot_transition_probabilities(lpcm)
    plt.close(fig)
    fig, ax = plots.alluvial_plot(z)
    plt.close(fig)
    fig, ax = plots.alluvial_plot(lpcm.zs_[-50:][::25].reshape(2, -1)[
        :, :lpcm.z_.shape[1]])
    plt.close(fig)


def test_posterior_counts_hdp(short_nested):
    Y, X, z = synthetic_static_community_dynamic_network(
        n_nodes=20, n_time_steps=2, n_groups=2, simulation_type='easy',
        random_state=5)
    m = DynamicNetworkHDPLPCM(n_iter=30, tune=30, burn=30, n_components=5,
                              random_state=2, device='cpu').fit(Y)
    fig, _ = plots.plot_posterior_counts(m, t=0)
    plt.close(fig)
    fig, _ = plots.plot_traces(m)
    plt.close(fig)


def test_palette_and_arrow_helpers():
    pytest.importorskip('seaborn')
    pal = plots.get_husl(25)
    assert pal.shape == (25,) and all(c.startswith('#') for c in pal)
    assert plots.get_colors(np.arange(25)).shape[0] == 25
    fig, ax = plt.subplots()
    arrow = plots.arrow_patch((0.0, 0.0), (1.0, 1.0), 60, 120, ax, color='k')
    assert arrow in ax.patches
    plt.close(fig)


# ---------------------------------------------------------------------------
# parity with the JAX package's plots on one stub model
# ---------------------------------------------------------------------------

T, N, K, S = 3, 12, 4, 60


def _stub(mixture, directed=False, seed=0):
    """A fitted-model stand-in: the arrays the plot functions read."""
    rng = np.random.RandomState(seed)
    Y = (rng.uniform(size=(T, N, N)) < 0.3).astype(np.float64)
    if not directed:
        Y = np.triu(Y, 1)
        Y = Y + np.swapaxes(Y, 1, 2)
    Y[:, np.arange(N), np.arange(N)] = 0
    m = types.SimpleNamespace(
        X_=rng.randn(T, N, 2), Y_fit_=Y, is_directed=directed, n_chains=1,
        n_burn_=20, logps_=rng.randn(S).cumsum(),
        intercepts_=rng.randn(S, 2 if directed else 1))
    if directed:
        m.radii_ = rng.dirichlet(np.ones(N))
    if mixture:
        co = rng.uniform(size=(T, N, N))
        co = (co + np.swapaxes(co, 1, 2)) / 2
        co[:, np.arange(N), np.arange(N)] = 1.0
        m.z_ = rng.randint(0, K, size=(T, N))
        m.mu_ = rng.randn(K, 2)
        m.sigma_ = rng.uniform(0.1, 1.0, size=K)
        m.lambdas_ = rng.uniform(size=S)
        m.gammas_ = rng.gamma(2.0, size=S)
        m.trans_weights_ = rng.dirichlet(np.ones(K), size=(T, K))
        m.cooccurrence_probas_ = co
        m.posterior_group_ids_ = [np.array([2, 3, 4])] * T
        m.posterior_group_counts_ = [rng.randint(1, 30, size=3)] * T
    return m


def _drawn(fig):
    """Everything a figure draws, as float arrays in data coordinates, in
    drawing order: line xy, image arrays, patch outlines (arrows by their
    end points), collection offsets and paths, text positions."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(line.get_xydata(), float)
                for line in ax.get_lines()]
        out += [np.asarray(im.get_array(), float) for im in ax.get_images()]
        for p in ax.patches:
            if hasattr(p, '_posA_posB') and p._posA_posB is not None:
                out.append(np.asarray(p._posA_posB, float))
            else:
                out.append(p.get_patch_transform().transform(
                    p.get_path().vertices))
        for c in ax.collections:
            out.append(np.asarray(c.get_offsets(), float))
            out += [np.asarray(path.vertices, float)
                    for path in c.get_paths()]
        for text in ax.texts:
            out.append(np.asarray(text.get_position(), float))
            if hasattr(text, 'xy'):
                out.append(np.asarray(text.xy, float))
        out.append(np.asarray(ax.get_xlim() + ax.get_ylim(), float))
    return out


def _same_drawing(draw):
    """Draw with both modules' function of one name and compare."""
    figs = []
    for mod in (jax_plots, plots):
        fig = draw(mod)
        fig = fig[0] if isinstance(fig, tuple) else fig
        figs.append(_drawn(fig))
        plt.close(fig)
    want, got = figs
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


PARITY = {
    'traces lsm': lambda mod: mod.plot_traces(_stub(False)),
    'traces lsm directed': lambda mod: mod.plot_traces(
        _stub(False, directed=True)),
    'traces mixture': lambda mod: mod.plot_traces(_stub(True)),
    'latent space lsm': lambda mod: mod.plot_latent_space(
        _stub(False), t=1, node_names=['v%d' % i for i in range(N)]),
    'latent space lsm directed': lambda mod: mod.plot_latent_space(
        _stub(False, directed=True), t=0),
    'latent space lpcm': lambda mod: mod.plot_latent_space(
        _stub(True), t=2, node_names=['v%d' % i for i in range(N)]),
    'adjacency': lambda mod: mod.plot_adjacency_matrix(
        _stub(True).Y_fit_[0], _stub(True).z_[0]),
    'probability': lambda mod: mod.plot_probability_matrix(
        _stub(True).cooccurrence_probas_[1], _stub(True).z_[1]),
    'cooccurrence': lambda mod: mod.plot_posterior_cooccurrence(
        _stub(True), t=1),
    'posterior counts': lambda mod: mod.plot_posterior_counts(_stub(True)),
    'transitions': lambda mod: mod.plot_transition_probabilities(
        _stub(True)),
    'alluvial': lambda mod: mod.alluvial_plot(_stub(True).z_ * 3 + 1),
    'contour and arrow': lambda mod: _contour_and_arrow(mod),
}


def _contour_and_arrow(mod):
    fig, ax = plt.subplots()
    mod.normal_contour(np.array([0.5, -1.0]), np.array([[2.0, 0.3],
                                                        [0.3, 0.5]]),
                       n_std=[1, 2], ax=ax)
    mod.arrow_patch((0.0, 0.0), (1.0, 2.0), 60, 120, ax, color='k')
    mod.draw_edge(np.array([0.0, 1.0]), np.array([2.0, -1.0]), ax)
    mod.draw_edge(np.array([0.0, 1.0]), np.array([2.0, -1.0]), ax,
                  is_directed=True)
    return fig


@pytest.mark.parametrize('name', sorted(PARITY))
def test_plots_draw_what_jax_draws(name):
    _same_drawing(PARITY[name])


def test_helpers_match_jax():
    rng = np.random.RandomState(3)
    for values in (rng.randn(300), np.full(5, 2.0)):
        for a, b in zip(plots._kde_curve(values),
                        jax_plots._kde_curve(values)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    z0, z1 = rng.randint(0, 4, size=(2, 30))
    for a, b in zip(plots.transition_freqs(z0, z1, 4),
                    jax_plots.transition_freqs(z0, z1, 4)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    anchors = rng.randn(9, 2)
    np.testing.assert_allclose(text_utils._relax(anchors, k=0.3),
                               jax_text._relax(anchors, k=0.3),
                               rtol=1e-12, atol=1e-12)
    assert list(plots.get_color20()) == list(jax_plots.get_color20())
    assert list(plots.get_colors(np.arange(7))) == list(
        jax_plots.get_colors(np.arange(7)))
    assert plots.flatten([[1, 2], [3]]) == [1, 2, 3]
    assert plots.__all__ == jax_plots.__all__
    fig, ax = plt.subplots()
    text_utils.repel_labels(ax, [0.0, 0.01, 1.0], [0.0, 0.0, 1.0],
                            ['a', 'b', 'c'], k=0.05)
    fig2, ax2 = plt.subplots()
    jax_text.repel_labels(ax2, [0.0, 0.01, 1.0], [0.0, 0.0, 1.0],
                          ['a', 'b', 'c'], k=0.05)
    for t1, t2 in zip(ax.texts, ax2.texts):
        np.testing.assert_allclose(t1.get_position(), t2.get_position(),
                                   rtol=1e-12, atol=1e-12)
        assert t1.get_text() == t2.get_text()
    plt.close(fig)
    plt.close(fig2)


def test_package_import_does_not_import_matplotlib():
    """``import dynetlsm_tpu_torch`` leaves matplotlib alone: the card's
    machine has none."""
    import subprocess
    import sys
    code = ('import sys; sys.modules["matplotlib"] = None; '
            'import dynetlsm_tpu_torch, dynetlsm_tpu_torch.text_utils; '
            'print("ok")')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == 'ok', out.stderr
