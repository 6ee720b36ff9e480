"""A tiny cell on the CPU: the harness's own run, with the shapes cut."""
import time

import torch

from port_bench import core


def tiny_spec(workload='hdp_ns_exact', T=4, n=40, K=5, chains=4,
              start='random', scheme='exact', n_control=None):
    spec = core.load_spec(workload)
    spec['config'] = dict(spec['config'], T=T, n=n, K=K,
                          program=dict(spec['config']['program'], K=K))
    program = dict(spec['traffic']['program'], latent_update=scheme,
                   quality_init=start == 'quality')
    if n_control is not None:
        program['n_control'] = n_control
    spec['traffic'] = dict(spec['traffic'], chains=chains, program=program)
    spec['params'] = dict(spec['params'], burn_in=2, chunk=2)
    return spec


def tiny_run(spec, seed=7, seconds=0.2, trace=False):
    torch.set_num_threads(1)
    return core.run(spec, seed, seconds, trace, torch.device('cpu'),
                    time.perf_counter())
