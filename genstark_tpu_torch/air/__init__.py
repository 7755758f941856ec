"""AIR layer of the port: IR, module with the proving and verification
contexts, the AirScript (script.py) and AirAssembly (assembly.py)
compilers, schema converter."""

from .ir import AirSchema, CyclicRegister, InputRegister, MaskRegister
from .module import AirModule, ProvingContext, VerificationContext

__all__ = ["AirSchema", "CyclicRegister", "InputRegister", "MaskRegister",
           "AirModule", "ProvingContext", "VerificationContext"]
