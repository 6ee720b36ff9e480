"""Synthetic dynamic-network generators (counterpart of
``dynetlsm_tpu/datasets/samples_generator.py``), in NumPy alone.

Copies of the JAX package's generators, which make the same draws from
the same ``np.random.RandomState`` in the same order, so a seed gives the
JAX package's arrays: Markov-switching Gaussian-mixture latent
trajectories pushed through the logistic distance link (reference
dynetlsm/datasets/samples_generator.py).  scikit-learn's
``check_random_state`` and ``pairwise_distances`` are the port's own
(``math/init.py``).
"""
from math import ceil

import numpy as np
from scipy.special import expit

from ..math.init import check_random_state, euclidean_distances

__all__ = ['network_from_dynamic_latent_space',
           'simple_splitting_dynamic_network',
           'merging_dynamic_network',
           'merging_block_model',
           'synthetic_static_community_dynamic_network',
           'synthetic_dynamic_network',
           'inhomogeneous_simulation',
           'homogeneous_simulation',
           'forecast_probas_map',
           'forecast_probas']


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _distances(X):
    if X.ndim == 2:
        return euclidean_distances(X)
    return np.stack([euclidean_distances(X[t]) for t in range(X.shape[0])])


def _sticky_transition_matrix(mus, sticky_const=20.0):
    """Transition weights proportional to inverse mean distance with a
    sticky diagonal (reference samples_generator.py:143-150)."""
    with np.errstate(divide='ignore'):
        wt = 1.0 / euclidean_distances(mus)
    di = np.diag_indices_from(wt)
    wt[di] = 0.0
    wt[di] = sticky_const * wt.max(axis=1)
    return wt / wt.sum(axis=1, keepdims=True)


def _regime_change_matrix(old_mus, new_mus, sticky_rows=None,
                          sticky_const=None):
    """Transition weights from old regime means to new regime means; exact
    matches (zero distance) get the row maximum — optionally scaled by the
    sticky constant (reference samples_generator.py:188-195, 633-639)."""
    with np.errstate(divide='ignore'):
        wt = 1.0 / euclidean_distances(old_mus, new_mus)
    inf = ~np.isfinite(wt)
    wt[inf] = 0.0
    # one exact match per affected row: flat masked assignment walks the
    # rows in order (reference samples_generator.py:192-195, 999-1002)
    vals = wt.max(axis=1)
    if sticky_const is not None:
        vals = sticky_const * vals
        if sticky_rows is not None:
            vals = vals[sticky_rows]
    wt[inf] = vals[:inf.sum()]
    return wt / wt.sum(axis=1, keepdims=True)


def _markov_labels(rng, z_prev, wt, group_ids, out_ids=None):
    """Advance node labels one step under transition rows ``wt``.

    group_ids are the label values indexing rows of wt; out_ids the label
    values of the columns (defaults to group_ids).
    """
    out_ids = group_ids if out_ids is None else out_ids
    zt = np.zeros_like(z_prev)
    for row, g in enumerate(group_ids):
        mask = z_prev == g
        if mask.any():
            zt[mask] = rng.choice(out_ids, p=wt[row], size=mask.sum())
    return zt


def _mixture_positions(rng, zt, mus_by_label, sigmas_by_label, X_prev=None,
                       lmbda=1.0):
    """Draw positions given labels: N(mu_z, sig_z) at t=0, else
    N(lam*mu_z + (1-lam)*x_prev, sig_z)."""
    n = zt.shape[0]
    d = next(iter(mus_by_label.values())).shape[0]
    Xt = np.zeros((n, d))
    for g, mu in mus_by_label.items():
        mask = zt == g
        if not mask.any():
            continue
        base = mu if X_prev is None else lmbda * mu + (1 - lmbda) * X_prev[mask]
        Xt[mask] = sigmas_by_label[g] * rng.randn(mask.sum(), d) + base
    return Xt


def network_from_dynamic_latent_space(X, intercept=1, coef=1, radii=None,
                                      random_state=None):
    """Sample adjacency tensors from the logistic latent-distance link
    (reference samples_generator.py:78-104).  Directed when radii given."""
    rng = check_random_state(random_state)
    T, n, _ = X.shape
    dij = _distances(X)
    if radii is not None:
        d_in = 1 - dij / radii[None, None, :]
        d_out = 1 - dij / radii[None, :, None]
        probas = expit(intercept[0] * d_in + intercept[1] * d_out)
        # no self-loops (reference directed_network_probas zeroes the diag)
        probas *= 1.0 - np.eye(n)[None]
    else:
        probas = expit(intercept - coef * dij)

    Y = np.zeros((T, n, n))
    for t in range(T):
        draw = rng.binomial(1, probas[t]).astype(float)
        if radii is None:
            draw = np.triu(draw, 1)
            draw += draw.T
        Y[t] = draw
    return Y, probas


def _directed_extras(rng, X0):
    """Radii + intercepts for the directed generator variants
    (reference samples_generator.py:249-253)."""
    norms = 1.0 / np.linalg.norm(X0, axis=1)
    norms /= norms.max()
    radii = rng.dirichlet(100 * norms)
    return radii, np.array([0.3, 0.7])


# ---------------------------------------------------------------------------
# one-step-ahead ground-truth forecasters
# ---------------------------------------------------------------------------

def forecast_probas_map(X, z, wt, lmbda, mu, intercept):
    """Plug-in one-step-ahead probabilities
    (reference samples_generator.py:29-39)."""
    ws = wt[z]
    X_ahead = np.zeros_like(X)
    for g in np.unique(z):
        X_ahead += ws[:, [g]] * (lmbda * mu[g] + (1 - lmbda) * X)
    return expit(intercept - _distances(X_ahead))


def forecast_probas(X, z, wt, lmbda, mu, sigma, intercept, n_samples=5000,
                    random_state=None):
    """Monte-Carlo one-step-ahead probabilities
    (reference samples_generator.py:42-75)."""
    rng = check_random_state(random_state)
    n, d = X.shape
    n_groups = mu.shape[0]
    probas = np.zeros((n, n))
    for _ in range(n_samples):
        zt = _markov_labels(rng, z, wt, list(range(n_groups)))
        Xt = _mixture_positions(
            rng, zt, {g: mu[g] for g in range(n_groups)},
            {g: sigma[g] for g in range(n_groups)}, X_prev=X, lmbda=lmbda)
        probas += expit(intercept - _distances(Xt)) / n_samples
    np.fill_diagonal(probas, 0)
    return probas


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def simple_splitting_dynamic_network(n_nodes=120, n_time_steps=9,
                                     intercept=1.0, lmbda=0.8,
                                     sticky_const=20.0, sigma_shape=6,
                                     sigma_scale=20, is_directed=False,
                                     random_state=42):
    """Two communities split into four halfway through
    (reference samples_generator.py:107-260)."""
    rng = check_random_state(random_state)
    time_chunks = ceil(n_time_steps / 2)

    all_mus = np.array([[-1.5, 0.], [1.5, 0.],
                        [-1.5, 0.], [1.5, 0.], [0, 3.0], [0, -3.0]])
    if is_directed:
        all_mus = all_mus / 100.0
        sigma_scale, sigma_shape = 1e5, 13
    sigmas = np.sqrt(1.0 / rng.gamma(shape=sigma_shape, scale=sigma_scale,
                                     size=all_mus.shape[0]))

    first_ids = [0, 1]
    second_ids = [2, 3, 4, 5]
    mu_of = {g: all_mus[g] for g in range(6)}
    sig_of = {g: sigmas[g] for g in range(6)}

    # t = 0
    w0 = rng.dirichlet(np.repeat(10, 2))
    z0 = rng.choice(first_ids, p=w0, size=n_nodes)
    X, z = [_mixture_positions(rng, z0, mu_of, sig_of)], [z0]

    # first regime
    wt = _sticky_transition_matrix(all_mus[first_ids], sticky_const)
    for t in range(1, time_chunks):
        zt = _markov_labels(rng, z[-1], wt, first_ids)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    # split 2 -> 4
    wt_merge = _regime_change_matrix(all_mus[first_ids], all_mus[second_ids])
    zt = _markov_labels(rng, z[-1], wt_merge, first_ids, out_ids=second_ids)
    X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
    z.append(zt)

    # second regime
    wt = _sticky_transition_matrix(all_mus[second_ids], sticky_const)
    for t in range(time_chunks + 1, 2 * time_chunks):
        zt = _markov_labels(rng, z[-1], wt, second_ids)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    X = np.stack(X)
    z = np.vstack(z)

    radii = None
    if is_directed:
        radii, intercept = _directed_extras(rng, X[0])
    Y, _ = network_from_dynamic_latent_space(X, intercept=intercept,
                                             radii=radii, random_state=rng)
    return Y, z


def merging_dynamic_network(n_nodes=120, n_time_steps=5, intercept=1.0,
                            lmbda=0.6, random_state=42):
    """Two communities gradually absorbed into a central one
    (reference samples_generator.py:264-321)."""
    rng = check_random_state(random_state)
    mus = np.array([[-5., 0.], [5., 0.], [0., 0.]])
    sigmas = np.ones(3)
    mu_of = {g: mus[g] for g in range(3)}
    sig_of = {g: sigmas[g] for g in range(3)}

    z0 = rng.choice([0, 1], p=[0.5, 0.5], size=n_nodes)
    X, z = [_mixture_positions(rng, z0, mu_of, sig_of)], [z0]

    for t in range(1, n_time_steps):
        if t > 2:
            zt = np.full(n_nodes, 2, dtype=int)
        else:
            wt = np.array([[1 - t / 4., 0., t / 4.],
                           [0., 1 - t / 4., t / 4.],
                           [0., 0., 1.]])
            zt = _markov_labels(rng, z[-1], wt, [0, 1, 2])
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    X = np.stack(X)
    z = np.vstack(z)
    Y, probas = network_from_dynamic_latent_space(X, intercept=intercept,
                                                  random_state=rng)
    return Y, X, z, intercept, probas, mus, sigmas


def merging_block_model(n_nodes=100, n_time_steps=6, p_in=0.6,
                        trans_proba=0.1, random_state=42):
    """Stochastic block model whose between-block probability rises until the
    blocks merge (reference samples_generator.py:325-363)."""
    rng = check_random_state(random_state)
    Y = np.zeros((n_time_steps, n_nodes, n_nodes))
    z = [rng.choice([0, 1], p=[0.5, 0.5], size=n_nodes)]
    il = np.tril_indices(n_nodes, k=-1)

    wt = np.array([[1 - trans_proba, trans_proba],
                   [trans_proba, 1 - trans_proba]])

    for t in range(n_time_steps):
        if t > 0:
            z.append(_markov_labels(rng, z[-1], wt, [0, 1]))
        Z = np.eye(2)[z[t]]
        same = Z @ Z.T
        p_between = p_in * min((t + 1) / 5.0, 1.0) if t > 0 else p_in / 5.0
        probas = p_in * same + p_between * (1 - same)
        vec = rng.binomial(1, probas[il])
        Y[t][il] = vec
        Y[t] += Y[t].T
    return Y, np.asarray(z)


def synthetic_static_community_dynamic_network(
        n_nodes=100, n_time_steps=5, n_groups=6, simulation_type=None,
        random_state=42):
    """Fixed community structure with Markov label switching (reference
    samples_generator.py:365-476), undirected: the JAX package's generator
    with its draws.  Returns (Y (T, n, n), X (T, n, 2), z (T, n)), the
    first three of the JAX generator's six arrays."""
    rng = check_random_state(random_state)
    mus = np.array([[-4., 0.], [4., 0.], [-2., 0.], [2., 0.],
                    [0., 5.0], [0., -5.0]])
    sigma_shape, sigma_scale = {'easy': (6, 20), 'hard': (6, 0.5)}.get(
        simulation_type, (3, 0.5))
    intercept, lmbda, sticky_const = 1.0, 0.8, 20.0
    if n_groups > 6:
        raise ValueError('Only a maximum of six groups allowed for now.')

    sigmas = np.sqrt(1.0 / rng.gamma(shape=sigma_shape, scale=sigma_scale,
                                     size=n_groups))
    ids = list(range(n_groups))
    mu_of = {g: mus[g] for g in ids}
    sig_of = {g: sigmas[g] for g in ids}

    w0 = rng.dirichlet(np.repeat(10, n_groups))
    z0 = rng.choice(ids, p=w0, size=n_nodes)
    X, z = [_mixture_positions(rng, z0, mu_of, sig_of)], [z0]

    wt = _sticky_transition_matrix(mus[:n_groups], sticky_const)
    for t in range(1, n_time_steps):
        zt = _markov_labels(rng, z[-1], wt, ids)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    X = np.stack(X)
    z = np.vstack(z)
    Y, _ = network_from_dynamic_latent_space(X, intercept=intercept,
                                             random_state=rng)
    return Y, X, z


def homogeneous_simulation(n_nodes=120, n_time_steps=6,
                           simulation_type='easy', lmbda=0.8, intercept=1.0,
                           random_state=42):
    """Time-homogeneous six-community simulation study
    (reference samples_generator.py:701-796)."""
    rng = check_random_state(random_state)
    if simulation_type != 'custom':
        lmbda, intercept = 0.8, 1.0
    mus = np.array([[-4., 0.], [4., 0.], [-2., 0.], [2., 0.],
                    [0., 5.0], [0., -5.0]])
    sigma_shape = 6 if simulation_type in ('easy', 'custom') else 3
    sigma_scale, sticky_const = 0.5, 20.0

    n_groups = mus.shape[0]
    sigmas = np.sqrt(1.0 / rng.gamma(shape=sigma_shape, scale=sigma_scale,
                                     size=n_groups))
    ids = list(range(n_groups))
    mu_of = {g: mus[g] for g in ids}
    sig_of = {g: sigmas[g] for g in ids}

    w0 = rng.dirichlet(np.repeat(10, n_groups))
    z0 = rng.choice(ids, p=w0, size=n_nodes)
    X, z = [_mixture_positions(rng, z0, mu_of, sig_of)], [z0]

    wt = _sticky_transition_matrix(mus, sticky_const)
    for t in range(1, n_time_steps):
        zt = _markov_labels(rng, z[-1], wt, ids)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    X = np.stack(X)
    z = np.vstack(z)
    Y, probas = network_from_dynamic_latent_space(X, intercept=intercept,
                                                  random_state=rng)
    probas_ahead = forecast_probas(X[-2], z[-2], wt, lmbda, mus, sigmas,
                                   intercept, random_state=rng)
    return Y, X, z, intercept, mus, sigmas, probas, probas_ahead


def inhomogeneous_simulation(n_nodes=120, simulation_type='easy', lmbda=0.9,
                             intercept=1.0, random_state=42):
    """2 -> 6 -> 4 community split/merge over 10 steps
    (reference samples_generator.py:479-698)."""
    rng = check_random_state(random_state)
    if simulation_type != 'custom':
        lmbda, intercept = 0.9, 1.0
    all_mus = np.array([[-2., 0.], [2., 0.], [-4., 0.], [4., 0.],
                        [0., 5.0], [0., -5.0]])
    sigma_shape = 6 if simulation_type in ('easy', 'custom') else 3
    sigma_scale, sticky_const = 0.5, 20.0

    sigmas = np.sqrt(1.0 / rng.gamma(shape=sigma_shape, scale=sigma_scale,
                                     size=6))
    mu_of = {g: all_mus[g] for g in range(6)}
    sig_of = {g: sigmas[g] for g in range(6)}

    stage1 = [0, 1]
    stage2 = [0, 1, 2, 3, 4, 5]
    stage3 = [0, 1, 2, 3]

    z0 = rng.choice(stage1, p=[0.5, 0.5], size=n_nodes)
    X, z = [_mixture_positions(rng, z0, mu_of, sig_of)], [z0]

    wt = _sticky_transition_matrix(all_mus[stage1], sticky_const)
    for t in range(1, 3):
        zt = _markov_labels(rng, z[-1], wt, stage1)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    # split 2 -> 6
    wt_m = _regime_change_matrix(all_mus[stage1], all_mus[stage2])
    zt = _markov_labels(rng, z[-1], wt_m, stage1, out_ids=stage2)
    X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
    z.append(zt)

    wt = _sticky_transition_matrix(all_mus[stage2], sticky_const)
    for t in range(4, 6):
        zt = _markov_labels(rng, z[-1], wt, stage2)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    # merge 6 -> 4
    wt_m = _regime_change_matrix(all_mus[stage2], all_mus[stage3],
                                 sticky_rows=stage3,
                                 sticky_const=sticky_const)
    zt = _markov_labels(rng, z[-1], wt_m, stage2, out_ids=stage3)
    X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
    z.append(zt)

    wt = _sticky_transition_matrix(all_mus[stage3], sticky_const)
    for t in range(7, 10):
        zt = _markov_labels(rng, z[-1], wt, stage3)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    X = np.stack(X)
    z = np.vstack(z)
    Y, probas = network_from_dynamic_latent_space(X, intercept=intercept,
                                                  random_state=rng)
    probas_ahead = forecast_probas(X[-2], z[-2], wt, lmbda,
                                   all_mus[stage3], sigmas[stage3],
                                   intercept, random_state=rng)
    return Y, X, z, intercept, all_mus, sigmas, probas, probas_ahead


def synthetic_dynamic_network(n_nodes=120, n_time_steps=9, intercept=1.0,
                              lmbda=0.8, sticky_const=20.0, sigma_shape=6,
                              sigma_scale=20, is_directed=False,
                              simulation_type='easy', random_state=42):
    """Split 2 -> 6 then merge 6 -> 4 over three chunks
    (reference samples_generator.py:799-1068)."""
    rng = check_random_state(random_state)
    time_chunks = ceil(n_time_steps / 3)

    if is_directed:
        all_mus = np.array([[-1.5, -2 / 3.], [1.5, 2 / 3.], [-3., 0.],
                            [3., 0.], [-1.0, 0.], [1.0, 0.],
                            [0., 2.0], [0., -2.0]]) / 100.0
        sigma_scale, sigma_shape = 1e5, 13
        lmbda = 0.9
    else:
        all_mus = np.array([[-2., 0.], [2., 0.], [-4., 0.], [4., 0.],
                            [0., 5.0], [0., -5.0]])
        sigma_scale = 20 if simulation_type == 'easy' else 0.5
        sigma_shape, intercept, lmbda = 6, 1.0, 0.9

    sigmas = np.sqrt(1.0 / rng.gamma(shape=sigma_shape, scale=sigma_scale,
                                     size=6))
    n_all = min(all_mus.shape[0], 6)
    mu_of = {g: all_mus[g] for g in range(all_mus.shape[0])}
    sig_of = {g: sigmas[g % 6] for g in range(all_mus.shape[0])}

    stage1 = [0, 1]
    stage2 = list(range(n_all))
    stage3 = [0, 1, 2, 3]

    z0 = rng.choice(stage1, p=[0.5, 0.5], size=n_nodes)
    X, z = [_mixture_positions(rng, z0, mu_of, sig_of)], [z0]

    wt = _sticky_transition_matrix(all_mus[stage1], sticky_const)
    for t in range(1, time_chunks):
        zt = _markov_labels(rng, z[-1], wt, stage1)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    wt_m = _regime_change_matrix(all_mus[stage1], all_mus[stage2])
    zt = _markov_labels(rng, z[-1], wt_m, stage1, out_ids=stage2)
    X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
    z.append(zt)

    wt = _sticky_transition_matrix(all_mus[stage2], sticky_const)
    for t in range(time_chunks + 1, 2 * time_chunks):
        zt = _markov_labels(rng, z[-1], wt, stage2)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    wt_m = _regime_change_matrix(all_mus[stage2], all_mus[stage3],
                                 sticky_rows=stage3,
                                 sticky_const=sticky_const)
    zt = _markov_labels(rng, z[-1], wt_m, stage2, out_ids=stage3)
    X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
    z.append(zt)

    wt = _sticky_transition_matrix(all_mus[stage3], sticky_const)
    for t in range(2 * time_chunks + 1, n_time_steps + 1):
        zt = _markov_labels(rng, z[-1], wt, stage3)
        X.append(_mixture_positions(rng, zt, mu_of, sig_of, X[-1], lmbda))
        z.append(zt)

    X = np.stack(X)
    z = np.vstack(z)

    radii = None
    if is_directed:
        radii, intercept = _directed_extras(rng, X[0])
    Y, probas = network_from_dynamic_latent_space(
        X, intercept=intercept, radii=radii, random_state=rng)
    return Y, X, z, intercept, radii, probas
