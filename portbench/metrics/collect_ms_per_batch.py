"""collect_ms_per_batch.<suffix> (ms; span around the program's call;
host unpack on the caller's thread): the mean time of
GpuCodec.collect_batch over the traced window's batches, the wait for the
batch's device work included."""


def read(run):
    s = run.rec.seconds("collect") if run.rec else []
    return 1e3 * sum(s) / len(s) if s else None
