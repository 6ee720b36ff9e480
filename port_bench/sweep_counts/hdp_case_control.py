"""The undirected HDP-LPCM sweep on the case-control estimator: the latent
update and the intercept step over each row's edges and its m controls
(the traffic's ``n_control``), and the mixture blocks.  No dense node
scan runs."""
from port_bench import counts


def count(spec, net):
    config, C = spec['config'], spec['traffic']['chains']
    T, n, K = config['T'], config['n'], config['K']
    m, edges = spec['traffic']['program']['n_control'], net['edges']
    return {'sweep_flops': counts.cc_latent_flops(C, T, n, edges, m)
            + counts.cc_intercept_flops(C, T, n, edges, m)
            + counts.mixture_flops(C, T, n, K)}
