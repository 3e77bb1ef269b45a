"""device_idle_pct.<suffix> (%; device trace; the device): the share of the
traced window in which no kernel or copy ran on the card (the union of
the profiler's CUDA intervals)."""


def read(run):
    d = run.device
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"]) if d else None
