"""The device's idle share of the traced window: 1 - the union of its
activity intervals over the window, between the window's markers."""


def read(ctx):
    busy, window = ctx.get('busy_s'), ctx.get('device_window_s')
    if busy is None or not window:
        return None
    return 100.0 * (1.0 - busy / window)
