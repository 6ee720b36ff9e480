"""Dense likelihood ops and the wrappers of the hand-written kernels.

The names below are the JAX package's ``dynetlsm_tpu.ops`` exports; the
kernel wrappers (``node_scan``, ``pair_loglik``, ``dir_loglik``) and the
case-control, forecast and shard modules are imported by name.  Importing
the package builds no kernel."""
from .distances import distances_to_point, pairwise_distances
from .emissions import (
    emission_likelihoods, emission_logliks, spherical_normal_logpdf)
from .likelihoods import (
    directed_eta, directed_intercept_grad, directed_loglik_full,
    directed_network_probas, directed_partial_loglik,
    dynamic_network_loglikelihood_directed,
    dynamic_network_loglikelihood_undirected, undirected_loglik_full,
    undirected_network_probas, undirected_partial_loglik)

__all__ = [
    'pairwise_distances', 'distances_to_point', 'undirected_loglik_full',
    'undirected_partial_loglik', 'directed_loglik_full',
    'directed_partial_loglik', 'directed_eta', 'directed_network_probas',
    'undirected_network_probas', 'directed_intercept_grad',
    'dynamic_network_loglikelihood_undirected',
    'dynamic_network_loglikelihood_directed', 'spherical_normal_logpdf',
    'emission_logliks', 'emission_likelihoods']
