"""The plain reference: NumPy and plain PyTorch, independent of the program.

It imports neither ``jax`` nor either package of this repository, and takes
nothing that the program made: only the observations and the keys that the
harness hands to both sides.
"""
