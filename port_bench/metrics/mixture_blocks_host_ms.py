"""Host milliseconds a sweep spends inside the mixture blocks
(``mcmc/{labels,hdp,conjugate}.py`` through ``mcmc/sweeps.py``): the
labels, tables, Dirichlet, conjugate and concentration calls."""

BLOCKS = ('sample_labels_block', 'sample_tables', 'sample_mbar',
          'sample_dirichlet', 'sample_cluster_means',
          'sample_cluster_variances', 'sample_lambda',
          'sample_mean_variance_hyper', 'sample_sigma_scale_hyper',
          'sample_concentration_param', 'sample_alpha_kappa_rho')


def read(ctx):
    spans = [iv for name in BLOCKS for iv in ctx['spans'].get(name, ())]
    if not spans or not ctx['sweeps']:
        return None
    return sum(e - s for s, e in spans) / ctx['sweeps'] / 1e6
