"""The prover: single proofs (`prove_on_device`, also named `prove`;
`TorchProver`) and batches of same-shape traces (`BatchProver`, `prove_batch_on_device`)."""

from .batch_prove import BatchProver, prove_batch_on_device  # noqa: F401
from .prove import TorchProver, prove, prove_on_device  # noqa: F401
