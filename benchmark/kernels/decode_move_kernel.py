"""B4 ``aps_decode_move`` (and its chain form): decode the extents and move
each slot's row of ``row_words`` 32-bit words.  Work: the extents read and the
ancestors written (4 bytes a slot), the rows written, and only the rows that
own a slot read (their share from the reference's firings, ``owner_share``)."""

NAME = "decode_move_kernel"
LAYER = "resampling"


def work(run) -> dict:
    n, d = run.particles_per_call, run.row_words
    return {"bytes": n * (8 + 4 * d * (1.0 + run.owner_share))}
