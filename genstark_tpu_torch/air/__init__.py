"""AIR layer of the port: IR, module with the proving and verification
contexts, the AirScript (script.py) and AirAssembly (assembly.py)
compilers, schema converter."""

from .ir import (AirSchema, Const, CyclicRegister, Expr, InputRegister, MaskRegister, const,
                 nxt, seed, static, trace)
from .module import AirModule, ProvingContext, VerificationContext

__all__ = ["AirSchema", "Const", "CyclicRegister", "Expr", "InputRegister", "MaskRegister",
           "AirModule", "ProvingContext", "VerificationContext", "const", "nxt", "seed",
           "static", "trace"]
