"""host_half_s_per_gb.<suffix> (s/GB; the program's counter; host half):
the seconds GpuCodec.finish_block_host spent over the traced window,
summed over the host pool's threads (BlockStats.total_seconds), per GB
(10**9 bytes) of the blocks it finished."""


def read(run):
    sec = run.host_after[0] - run.host_before[0]
    gb = (run.host_after[1] - run.host_before[1]) / 1e9
    return sec / gb if gb > 0 else None
