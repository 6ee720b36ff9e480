"""Host milliseconds a sweep call takes in the runner (``mcmc/driver.py``),
no synchronisation: the driver layer's dispatch of one sweep."""


def read(ctx):
    sweeps = ctx['spans'].get('sweep')
    if not sweeps:
        return None
    return sum(e - s for s, e in sweeps) / len(sweeps) / 1e6
