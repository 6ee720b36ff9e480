"""Samplers, densities, Procrustes alignment and the fit initialisers.

The names below are the JAX package's ``dynetlsm_tpu.math`` exports."""
from .distributions import (
    dirichlet_logpdf, multivariate_t_logpdf, multivariate_t_pdf, sample_beta,
    sample_categorical_logits, sample_dirichlet, sample_gamma,
    sample_inv_gamma, truncated_normal, truncated_normal_logpdf)
from .init import (
    directed_intercept_mle, generalized_mds, initialize_radii,
    longitudinal_kmeans, scale_intercept_mle, shortest_path_dissimilarity)
from .procrustes import (
    longitudinal_procrustes_rotation, longitudinal_procrustes_transform,
    procrustes_rotation, static_procrustes_rotation)

__all__ = [
    'sample_dirichlet', 'dirichlet_logpdf', 'truncated_normal',
    'truncated_normal_logpdf', 'sample_categorical_logits',
    'sample_inv_gamma', 'sample_gamma', 'sample_beta',
    'multivariate_t_logpdf', 'multivariate_t_pdf', 'procrustes_rotation',
    'static_procrustes_rotation', 'longitudinal_procrustes_rotation',
    'longitudinal_procrustes_transform', 'generalized_mds',
    'longitudinal_kmeans', 'initialize_radii', 'scale_intercept_mle',
    'directed_intercept_mle', 'shortest_path_dissimilarity']
