"""ratio_pct (%, lower is better; host clock): the bytes of every frame
the window returned over the bytes of their inputs, times 100. Users pay
for stored bytes, so a faster program that compresses worse is a
different result."""


def read(run):
    done = [c for c in run.window.calls if c.frame is not None]
    size = sum(len(c.data) for c in done)
    return 100.0 * sum(len(c.frame) for c in done) / size if size else None
