"""A whole sweep's share of the card's float32 peak (``mcmc/sweeps.py``):
the sweep's counted operations (the cell's ``sweep_counts`` module) times
the sweeps of the traced window, over the window's seconds and 67
TFLOP/s."""
from port_bench import counts


def read(ctx):
    if not ctx['sweeps'] or not ctx['window_s']:
        return None
    return (100.0 * ctx['sweep_flops'] * ctx['sweeps'] / ctx['window_s']
            / counts.PEAK_FLOPS)
