"""The directed log-likelihood kernel's share of its roofline
(``ops/dir_loglik.py`` -> ``csrc/dir_loglik.cu``): the least time of the
window's launches (the larger of the counted operations over the float32
peak and the bytes over the HBM bandwidth, ``sweep_counts/hdp_directed.py``)
over the ``dir_loglik`` kernels' device time in the trace.  The work is
counted from the program's counters on the window's ``sweep`` spans: the
launches (``dir_loglik_launches``) and the candidate-dyads they scored
(``dir_loglik_dyads``; 1 to 3 candidates a launch).  None without a
trace, without the counters (a program that does not count the dyads) or
without a launch."""
from port_bench import counts
from port_bench.metrics.mixture_blocks_self_ms import program_spans
from port_bench.sweep_counts.hdp_directed import dir_loglik_work


def read(ctx):
    if not ctx.get('kernels') or ctx.get('dir_loglik') is None:
        return None
    spans = program_spans(ctx)
    if spans is None:
        return None
    sweeps = [s.counts for s in spans if s.name == 'sweep']
    launches = sum(c.get('dir_loglik_launches', 0) for c in sweeps)
    dyads = sum(c.get('dir_loglik_dyads', 0) for c in sweeps)
    spent = sum(e - s for name, s, e in ctx['kernels']
                if 'dir_loglik' in name)
    if not launches or not dyads or not spent:
        return None
    flops, nbytes = dir_loglik_work(ctx['dir_loglik'], launches, dyads)
    return 100.0 * counts.least_seconds(flops, nbytes) / (spent / 1e9)
