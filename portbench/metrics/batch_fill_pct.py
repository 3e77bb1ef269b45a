"""batch_fill_pct.<suffix> (%; counted at the program's boundary;
orchestration): real rows over the rows of every batch submitted to the
device half in the traced window (GpuCodec.submit_batch pads each batch
to the codec's batch size)."""


def read(run):
    b = run.rec.batches if run.rec else []
    return 100.0 * sum(r for r, _, _ in b) / sum(n for _, n, _ in b) \
        if b else None
