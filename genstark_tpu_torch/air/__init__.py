"""AIR layer of the port: IR, module/proving context, schema converter."""

from .ir import AirSchema, CyclicRegister, InputRegister, MaskRegister
from .module import AirModule, ProvingContext

__all__ = ["AirSchema", "CyclicRegister", "InputRegister", "MaskRegister",
           "AirModule", "ProvingContext"]
