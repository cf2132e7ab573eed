"""device_idle_pct.infer: % of the window's wall time in which no device operation ran, the eval forward (1 - the traced slice's device time a unit x the window's units / the window's time)."""


def read(run):
    return run.idle_pct()
