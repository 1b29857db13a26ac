"""``aps_pos_normal`` / ``aps_pos_uniform`` (``csrc/threefry.cu``): one draw an
id in the paired layout, ids ``2p`` and ``2p + 1`` sharing the cipher block
at counter ``p``.  A launch draws for every particle of the call (all chains
at once under the chain batch).  Work: the float32 draws written (the ids are
a counter the kernel could make itself, so they are not counted) and 79 int32
operations for each block the ids need, half a block a draw."""

NAME = "positional_kernel"
LAYER = "draws"


def work(run) -> dict:
    n = run.particles_per_call
    return {"bytes": 4 * n, "int_ops": 79 * n // 2}
