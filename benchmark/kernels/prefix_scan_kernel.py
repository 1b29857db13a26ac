"""B1 ``aps_extents_from_logw`` (and B6, the scaled prefix), one chain or the
chain batch (``csrc/resample.cu``): the float32 log-weights read once and the
int32 extents (or float32 prefix) written once, for every particle of the
call."""

NAME = "prefix_scan_kernel"
LAYER = "resampling"


def work(run) -> dict:
    return {"bytes": 8 * run.particles_per_call}
