"""The share of the traced window's sweeps replayed from a CUDA graph
(``dynetlsm_tpu_torch/mcmc/graphs.py``): the program's ``sweep`` spans
whose count ``graph_replays`` is set, over the window's sweeps, in %.  0
where the program never replays the sweep (the case-control sweeps read
device data on the host); None without the spans, or from a program
without graphs."""
from port_bench.metrics.mixture_blocks_self_ms import program_spans


def read(ctx):
    try:
        from dynetlsm_tpu_torch.mcmc import graphs  # noqa: F401
    except ImportError:
        return None
    spans = program_spans(ctx)
    if spans is None:
        return None
    replayed = sum(s.counts.get('graph_replays', 0) for s in spans
                   if s.name == 'sweep')
    return 100.0 * replayed / ctx['sweeps']
