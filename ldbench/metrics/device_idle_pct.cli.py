"""device_idle_pct.cli: the share of the traced window in which no kernel,
copy or memset ran on the card (``torch.profiler``, CUDA activity).
Nothing without a trace that saw the device."""


def read(run):
    tr = run.window.trace
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
