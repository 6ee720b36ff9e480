"""Gibbs blocks, the three sweeps, tempering and the chain runner.

The names below are the JAX package's ``dynetlsm_tpu.mcmc`` exports."""
from .coefficients import (
    sample_intercept_undirected, sample_intercepts_directed, sample_radii)
from .conjugate import (
    sample_cluster_means, sample_cluster_variances, sample_lambda,
    sample_mean_variance_hyper, sample_sigma_scale_hyper)
from .driver import (
    chain_mesh, collect_traces, make_scan_runner, replicate_state,
    shard_state)
from .hdp import (
    sample_alpha_kappa_rho, sample_concentration_param, sample_mbar,
    sample_tables)
from .labels import (
    latent_marginal_loglikelihood, sample_labels_block,
    sample_labels_block_lpcm, sample_labels_gibbs)
from .latent import sample_latent_positions
from .metropolis import (
    dirichlet_metropolis_step, maybe_tune, random_walk_accept,
    tune_step_size_dirichlet, tune_step_size_random_walk)
from .states import LSMState, MixtureState
from .sweeps import SweepConfig, make_hdp_sweep, make_lpcm_sweep, make_lsm_sweep
from .tempering import make_pt_step, replicate_tempered, temper_ladder

__all__ = [
    'tune_step_size_random_walk', 'tune_step_size_dirichlet', 'maybe_tune',
    'random_walk_accept', 'dirichlet_metropolis_step',
    'sample_latent_positions', 'sample_intercept_undirected',
    'sample_intercepts_directed', 'sample_radii', 'sample_labels_block',
    'sample_labels_block_lpcm', 'sample_labels_gibbs',
    'latent_marginal_loglikelihood', 'sample_tables', 'sample_mbar',
    'sample_concentration_param', 'sample_alpha_kappa_rho',
    'sample_cluster_means', 'sample_cluster_variances', 'sample_lambda',
    'sample_mean_variance_hyper', 'sample_sigma_scale_hyper', 'LSMState',
    'MixtureState', 'SweepConfig', 'make_lsm_sweep', 'make_lpcm_sweep',
    'make_hdp_sweep', 'chain_mesh', 'shard_state', 'replicate_state',
    'make_scan_runner', 'collect_traces', 'temper_ladder',
    'replicate_tempered', 'make_pt_step']
