from .batch import BatchVerifier, stack_witnesses, tile_witness  # noqa: F401
