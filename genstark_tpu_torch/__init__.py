"""genstark_tpu_torch — the STARK prover of genstark_tpu on PyTorch and CUDA.

The port of the JAX package ``genstark_tpu`` to one NVIDIA Hopper GPU.  It
imports torch and numpy only: never jax, never genstark_tpu.  Host-only code
(limb codecs, host field, AIR IR and front ends, query sampling, proof
codec, verifier) is carried as trimmed copies; the kernels the prover
reaches are hand-written CUDA for sm_90a in ``csrc/`` (see kernels.py), and
the execution trace is generated C++ built with g++ (native/).

Public API, the counterparts of the JAX package's `__init__.py:24-59`:

- `instantiate(schema_or_source, component, options, logger, *, device)`
  builds a Stark from an AirSchema, AirAssembly source text / bytes or a
  path to a `.aa` file;
- `instantiate_script(source, options, logger, base_path, *, device)`
  builds a Stark from AirScript source text / bytes or a path.

The positional arguments are the JAX package's, so a call written for it
runs here unchanged.

A Stark proves with `prove` (the one-fetch path) or `prove_staged` (stage
by stage, host transcript).  The layer-level API: `ntt.ntt` / `intt` /
`low_degree_extend`, `merkle.MerkleTree.create` / `prove_batch`, the
`DeviceField` ops (`field.create_prime_field(p).device_field(device)`).

Both put the Stark's tensors on the keyword-only `device`, the CUDA card
unless the caller asks for another: a CPU run passes `device="cpu"`.
`air.convert.schema_from_reference` rebuilds a schema made with the JAX
package.
"""

from __future__ import annotations

import os
from typing import Optional, Union

from .air import AirModule, AirSchema
from .field import create_prime_field
from .protocol import Assertion, Stark, StarkError, StarkProof
from .utils import Logger, noop_logger

__version__ = "0.1.0"


def _load_source(source: Union[str, bytes]) -> tuple:
    """Source text from text / bytes / a filesystem path.  Returns (text,
    the file's directory or None)."""
    if isinstance(source, bytes):
        return source.decode(), None
    if "\n" not in source and os.path.isfile(source):
        with open(source) as fh:
            return fh.read(), os.path.dirname(os.path.abspath(source))
    return source, None


def instantiate(schema: Union[AirSchema, str, bytes], component: str = "default",
                options: Optional[dict] = None, logger: Optional[Logger] = None, *,
                device="cuda") -> Stark:
    """A Stark for `schema` (an AirSchema, or AirAssembly source text,
    bytes or a path, whose export `component` is compiled) with its tensors
    on `device` (a torch.device or its name); `logger` (a utils.Logger)
    prints the proving steps."""
    options = options or {}
    if isinstance(schema, (str, bytes)):
        from .air.assembly import compile_assembly
        source, _ = _load_source(schema)
        schema = compile_assembly(source, component)
    air = AirModule(schema, extension_factor=options.get("extension_factor"))
    return Stark(air, options, logger, device=device)


def instantiate_script(source: Union[str, bytes], options: Optional[dict] = None,
                       logger: Optional[Logger] = None, base_path: Optional[str] = None, *,
                       device="cuda") -> Stark:
    """A Stark from AirScript source text / bytes or a path.  `base_path`
    resolves relative AirAssembly import paths; when the source is a path it
    defaults to the file's directory."""
    from .air.script import compile_script
    text, file_dir = _load_source(source)
    schema = compile_script(text, base_path or file_dir)
    return instantiate(schema, "default", options, logger, device=device)


__all__ = ["AirSchema", "Assertion", "Logger", "Stark", "StarkError", "StarkProof",
           "create_prime_field", "instantiate", "instantiate_script", "noop_logger"]
