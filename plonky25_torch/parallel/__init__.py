from .mesh import make_mesh, make_batch_mesh, query_shardings  # noqa: F401
from .sharded import ShardedVerifier, verify_proof_sharded  # noqa: F401
from .batch import (  # noqa: F401
    BatchVerifier,
    stack_witnesses,
    tile_witness,
    verify_proof_batch,
)
from .multihost import (  # noqa: F401
    MultiHostBatchVerifier,
    init_distributed,
    make_host_mesh,
    verify_proof_batch_multihost,
)
