"""Host milliseconds a sweep spends in the directed model's coefficient
steps, ``sample_intercepts_directed`` (b_in, then b_out) and
``sample_radii`` (the Dirichlet-proposal step), each span less its child
spans (the radii's ``sample_dirichlet`` draw), from the program's own
spans (``dynetlsm_tpu_torch.tracing``), as ``mixture_blocks_self_ms``
reads the mixture blocks.  None without the spans."""
from port_bench.metrics.mixture_blocks_self_ms import children, program_spans

STEPS = ('sample_intercepts_directed', 'sample_radii')


def read(ctx):
    spans = program_spans(ctx)
    if spans is None:
        return None
    kids = children(spans)
    steps = [s for s in spans if s.name in STEPS]
    if not steps:
        return None
    total = sum(s.end_ns - s.start_ns
                - sum(e - b for b, e in kids.get(s.id, ()))
                for s in steps)
    return total / ctx['sweeps'] / 1e6
