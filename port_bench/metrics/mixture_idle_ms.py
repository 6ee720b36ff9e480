"""Device idle milliseconds a sweep while the innermost open program span
(``dynetlsm_tpu_torch.tracing``) is a mixture block (the blocks of
``mixture_blocks_self_ms``): the idle a CUDA graph of the sweep would
remove.  Idle is the complement of the union of the traced window's
device activity, between its first start and its last end; spans and
activity are on the profiler's clock."""
import bisect

from port_bench.metrics.mixture_blocks_self_ms import (
    MIXTURE, children, program_spans)


def idle_gaps(kernels):
    """The idle gaps (start, end) between the first kernel's start and the
    last one's end, in order."""
    gaps, end = [], None
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_within(intervals, gaps):
    """Nanoseconds of ``gaps`` (sorted, disjoint) inside ``intervals``
    (disjoint)."""
    starts = [g[0] for g in gaps]
    cum = [0]
    for g0, g1 in gaps:
        cum.append(cum[-1] + g1 - g0)

    def before(x):
        i = bisect.bisect_right(starts, x) - 1
        if i < 0:
            return 0
        return cum[i] + min(x, gaps[i][1]) - gaps[i][0]

    return sum(before(b) - before(a) for a, b in intervals)


def self_intervals(span, kids):
    """A span's interval less its direct children's."""
    out, at = [], span.start_ns
    for s, e in sorted(kids):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if span.end_ns > at:
        out.append((at, span.end_ns))
    return out


def read(ctx):
    spans = program_spans(ctx)
    if spans is None or not ctx.get('kernels'):
        return None
    kids = children(spans)
    own = [iv for s in spans if s.name in MIXTURE
           for iv in self_intervals(s, kids.get(s.id, ()))]
    return idle_within(own, idle_gaps(ctx['kernels'])) / ctx['sweeps'] / 1e6
