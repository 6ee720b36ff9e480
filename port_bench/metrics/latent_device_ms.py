"""Device milliseconds a sweep's latent update takes (``mcmc/latent.py``,
``ops/node_scan.py``, ``ops/case_control.py``): the kernels that run
between the markers around ``sample_latent_positions``, summed."""
import bisect


def read(ctx):
    kernels, latent = ctx.get('kernels'), ctx.get('latent')
    if not kernels or not latent:
        return None
    starts = [k[1] for k in kernels]
    total = 0
    for a, b in latent:
        i = bisect.bisect_left(starts, a)
        while i < len(kernels) and kernels[i][1] < b:
            total += min(kernels[i][2], b) - kernels[i][1]
            i += 1
    return total / len(latent) / 1e6
