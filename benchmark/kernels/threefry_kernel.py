"""``aps_threefry2x32`` (``csrc/threefry.cu``): both cipher words for each
element, one block an element; in the GP-SSM's step once for the particles'
keys and once for their draws.  A launch covers every particle of the call.
Work: the two uint32 words written and 79 int32 operations a block."""

NAME = "threefry_kernel"
LAYER = "draws"


def work(run) -> dict:
    n = run.particles_per_call
    return {"bytes": 8 * n, "int_ops": 79 * n}
