"""Approximate-BIC model selection over posterior cluster counts
(counterpart of ``dynetlsm_tpu/model_selection/approx_bic.py``, reference
model_selection/approx_bic.py): for each occupied-cluster count K observed
in the posterior, take the MAP sample with that count, renormalise it to
its active clusters, and score a two-part BIC (network likelihood +
forward-algorithm marginal of the latent mixture).

It runs on CPU tensors: a loop over ragged K-sized pieces.
"""
import numpy as np
import torch

from ..label_utils import calculate_cluster_counts, renormalize_sample
from ..mcmc.labels import latent_marginal_loglikelihood
from ..ops.distances import pairwise_distances
from ..ops.likelihoods import directed_loglik_full, undirected_loglik_full

__all__ = ['select_bic', 'DynamicNetworkMixtureModel']


class DynamicNetworkMixtureModel:
    """Container for a renormalised per-K MAP model
    (reference approx_bic.py:12-24)."""

    def __init__(self, beta, init_weights, trans_weights, X, mu, sigma,
                 lmbda, z, intercept, radii=None):
        self.beta = beta
        self.init_weights = init_weights
        self.trans_weights = trans_weights
        self.X = X
        self.mu = mu
        self.sigma = sigma
        self.lmbda = lmbda
        self.z = z
        self.intercept = intercept
        self.radii = radii


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def select_bic(Y, traces, n_burn, is_directed, n_features):
    """Per-K MAP extraction + BIC scoring (reference approx_bic.py:79-162).

    Y : (T, n, n) fitted network; traces : dict of arrays Xs, intercepts,
    mus, sigmas, betas, weights, lambdas, zs, logps (+ radiis if
    directed), sample axis first; n_burn : samples to discard from the
    front.

    Returns (bic (M, 4) [K, bic, net-loglik, map_id], models, counts).
    """
    T, n_nodes, _ = Y.shape
    zs = traces['zs']
    logps = traces['logps']
    counts = calculate_cluster_counts(zs, n_burn)
    Yt = _f32(Y)
    bic, models = [], []
    for k in np.unique(counts):
        masked = np.where(counts == k, logps[n_burn:], -np.inf)
        map_id = int(np.argmax(masked)) + n_burn

        X = traces['Xs'][map_id]
        intercept = traces['intercepts'][map_id]
        lmbda = float(np.ravel(traces['lambdas'][map_id])[0])
        radii = traces['radiis'][map_id] if is_directed else None

        _, beta_a, init_w, trans_w, mu_a, sigma_a = renormalize_sample(
            zs[map_id], traces['betas'][map_id], traces['weights'][map_id],
            traces['mus'][map_id], traces['sigmas'][map_id])

        dist = pairwise_distances(_f32(X))
        if is_directed:
            loglik_k = float(directed_loglik_full(
                Yt, dist, _f32(radii), float(intercept[0]),
                float(intercept[1])))
            bic_k = -2 * loglik_k
            n_params = 2 + n_nodes
            offdiag = Y.sum() - np.einsum('tii->', Y)
            bic_k += n_params * np.log(offdiag)
        else:
            loglik_k = float(undirected_loglik_full(Yt, dist,
                                                    float(intercept[0])))
            bic_k = -2 * loglik_k
            bic_k += np.log(0.5 * (Y.sum() - np.einsum('tii->', Y)))

        bic_k -= 2 * float(latent_marginal_loglikelihood(
            X, init_w, trans_w, mu_a, sigma_a, lmbda))

        n_params = ((n_features + 1) * k + (k - 1) + (k - 1)
                    + (T - 1) * k * (k - 1))
        bic_k += n_params * np.log(n_nodes * T)

        models.append(DynamicNetworkMixtureModel(
            beta=beta_a, init_weights=init_w, trans_weights=trans_w,
            X=X, mu=mu_a, sigma=sigma_a, lmbda=lmbda, z=zs[map_id],
            intercept=intercept, radii=radii))
        bic.append([k, bic_k, loglik_k, map_id])

    return np.array(bic), models, counts
