"""B4 over leaves ``aps_decode_move_leaves`` (and its chain form): one decode,
then every leaf's row moved; the GP-SSM's ``x`` and its 100-word history.
Work as B4's, with ``row_words`` the words of all leaves."""

NAME = "decode_move_leaves_kernel"
LAYER = "resampling"


def work(run) -> dict:
    n, d = run.particles_per_call, run.row_words
    return {"bytes": n * (8 + 4 * d * (1.0 + run.owner_share))}
