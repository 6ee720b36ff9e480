"""The undirected HDP-LPCM sweep on the dense likelihood: the latent update
('exact' or 'parallel') against every partner, the intercept step over
every dyad, and the mixture blocks."""
from port_bench import counts


def count(spec, net):
    config, C = spec['config'], spec['traffic']['chains']
    T, n, d, K = config['T'], config['n'], config['d'], config['K']
    latent = counts.latent_flops(C, T, n)
    return {'sweep_flops': latent + counts.intercept_flops(C, T, n)
            + counts.mixture_flops(C, T, n, K),
            'node_scan_flops': latent,
            'node_scan_bytes': counts.node_scan_bytes(C, T, n, d)}
