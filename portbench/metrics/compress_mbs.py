"""compress_mbs.<suffix> (MB/s, higher is better; host clock): input
bytes of every call completed in the window over the window's time, MB =
10**6 bytes. The window of a closed loop ends when its last call
returns, so the rate covers all the work and all the time."""


def read(run):
    w = run.window
    done = sum(len(c.data) for c in w.calls if c.end is not None)
    return done / w.seconds / 1e6 if done else None
