"""Protocol layer of the port: the prover's main path, the proof codec and
the verifier."""

from .fri import StarkError
from .proof import FriComponent, LowDegreeProof, StarkProof
from .stark import Assertion, Stark

__all__ = ["Assertion", "FriComponent", "LowDegreeProof", "Stark",
           "StarkError", "StarkProof"]
