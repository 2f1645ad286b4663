from .batch import (  # noqa: F401
    BatchVerifier,
    stack_witnesses,
    tile_witness,
    verify_proof_batch,
)
