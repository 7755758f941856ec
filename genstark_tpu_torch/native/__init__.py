"""Native (C++) host components of the port.

Counterpart of ``genstark_tpu/native/__init__.py``.  Execution-trace
generation is the one serial hot loop on the host: this package
code-generates a C++ translation unit per (AIR schema, modulus), compiles it
with g++ into a shared object (cached by source hash under
``genstark_tpu_torch/_build/native/``) and calls it through ctypes.  The
caller falls back to the Python interpreter only when no compiler exists.
"""

from .tracegen import NativeCompileError, NativeUnavailable, native_trace_fn

__all__ = ["native_trace_fn", "NativeCompileError", "NativeUnavailable"]
