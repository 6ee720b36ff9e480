"""Device idle milliseconds a sweep while the host is inside the program's
``sample_latent_positions`` span (``dynetlsm_tpu_torch.tracing``; under
case-control the colour classes' host-issued steps), on the profiler's
clock."""
from port_bench.metrics.mixture_blocks_self_ms import program_spans
from port_bench.metrics.mixture_idle_ms import idle_gaps, idle_within


def read(ctx):
    spans = program_spans(ctx)
    if spans is None or not ctx.get('kernels'):
        return None
    latent = [(s.start_ns, s.end_ns) for s in spans
              if s.name == 'sample_latent_positions']
    return (idle_within(latent, idle_gaps(ctx['kernels'])) / ctx['sweeps']
            / 1e6)
