"""Host reads of device data a sweep: the count ``host_syncs`` that the
program's ``sweep`` spans carry (``dynetlsm_tpu_torch.tracing``), over the
traced window's sweeps."""
from port_bench.metrics.mixture_blocks_self_ms import program_spans


def read(ctx):
    spans = program_spans(ctx)
    if spans is None:
        return None
    return sum(s.counts.get('host_syncs', 0) for s in spans
               if s.name == 'sweep') / ctx['sweeps']
