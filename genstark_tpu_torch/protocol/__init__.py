"""Protocol layer of the port: the prover's main path and proof codec."""

from .fri import StarkError
from .proof import FriComponent, LowDegreeProof, StarkProof
from .stark import Assertion, Stark

__all__ = ["Assertion", "FriComponent", "LowDegreeProof", "Stark",
           "StarkError", "StarkProof"]
