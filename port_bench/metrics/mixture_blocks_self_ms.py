"""Host milliseconds a sweep spends in the program's own mixture-block
spans (``dynetlsm_tpu_torch.tracing``), each less its child spans: the
labels, tables, mbar, Dirichlet, cluster means and variances, lambda, the
two hyper-priors, the concentrations and ``alpha_kappa_rho``.  The twin of
``mixture_blocks_host_ms``, without the benchmark's wrappers."""

MIXTURE = ('sample_labels_block', 'sample_tables', 'sample_mbar',
           'sample_dirichlet', 'sample_cluster_means',
           'sample_cluster_variances', 'sample_lambda',
           'sample_mean_variance_hyper', 'sample_sigma_scale_hyper',
           'sample_concentration_param', 'sample_alpha_kappa_rho')


def program_spans(ctx):
    """The spans the program recorded in the traced window (every one:
    no sweep runs outside it while the profiler records), or None when
    the program records none (no ``tracing`` module) or not one ``sweep``
    span a window sweep."""
    try:
        from dynetlsm_tpu_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    if sum(s.name == 'sweep' for s in spans) != ctx['sweeps']:
        return None
    return spans


def children(spans):
    """{span id: [(start, end) of each direct child span]}."""
    out = {}
    for s in spans:
        if s.parent is not None:
            out.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    return out


def read(ctx):
    spans = program_spans(ctx)
    if spans is None:
        return None
    kids = children(spans)
    total = sum(s.end_ns - s.start_ns
                - sum(e - b for b, e in kids.get(s.id, ()))
                for s in spans if s.name in MIXTURE)
    return total / ctx['sweeps'] / 1e6
