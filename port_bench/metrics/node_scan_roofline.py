"""The node-scan kernel's share of its roofline (``ops/node_scan.py`` ->
``csrc/node_scan.cu``): the least time of its launches (the larger of the
counted operations over the float32 peak and the bytes over the HBM
bandwidth, ``counts.py``) over their device time in the trace, one launch
a sweep of the exact scan."""
from port_bench import counts


def read(ctx):
    if (ctx['latent_update'] != 'exact' or not ctx.get('kernels')
            or ctx.get('node_scan_flops') is None):
        return None
    spent = sum(e - s for name, s, e in ctx['kernels']
                if 'node_scan' in name)
    if not spent:
        return None
    least = counts.least_seconds(ctx['node_scan_flops'],
                                 ctx['node_scan_bytes'])
    return 100.0 * least * ctx['sweeps'] / (spent / 1e9)
