"""AIR module + proving and verification contexts.

Counterpart of ``genstark_tpu/air/module.py`` (`AirModule`,
`ProvingContext`, `VerificationContext` and the input layout).  The trace
is generated on the host by the native C++ generator (native/tracegen.py,
built with g++) and, only where no C++ compiler exists, by the Python
interpreter; each context records which one ran in `trace_source`.  The
device trace scan (`_generate_execution_trace_device`) is not ported:
nothing in the JAX package calls it.  The trace ships as standard-form u32
limbs [R, L, T] (`generate_execution_trace_std`, the one-fetch prover's
input) or, for the staged prover, as a Montgomery tensor on the context's
device (`generate_execution_trace`); `evaluate_transition_constraints`
evaluates the constraint DAG over the composition domain with the torch
DeviceField, and the verification context evaluates it at one point with
host ints.

Domain conventions (identical to the JAX package):
  execution domain   size T            root w_t = w^ext
  composition domain size T*cf         root w_c = w^(ext/cf)
  evaluation domain  size T*ext        root w  ("context.root_of_unity")
with cf = 2^ceil(log2(max constraint degree)).
"""

from __future__ import annotations

from functools import cached_property
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..field.limbs import ints_to_limbs, limbs_to_ints
from ..native import NativeUnavailable, native_trace_fn
from .ir import (AirSchema, CyclicRegister, InputRegister, MaskRegister,
                 compile_host_fn, eval_device, eval_host)


def default_extension_factor(max_degree: int) -> int:
    """Smallest power of 2 strictly greater than 2*maxDegree."""
    e = 2
    while e <= 2 * max_degree:
        e *= 2
    return e


def composition_factor(max_degree: int) -> int:
    return max(1, 1 << (max_degree - 1).bit_length()) if max_degree > 1 else 1


class AirModule:
    def __init__(self, schema: AirSchema, extension_factor: Optional[int] = None):
        self.schema = schema
        self.field = schema.field
        maxdeg = schema.max_constraint_degree
        self.max_constraint_degree = maxdeg
        self.composition_factor = composition_factor(maxdeg)
        ext = extension_factor or default_extension_factor(maxdeg)
        if ext & (ext - 1) or ext < 2:
            raise ValueError("extension factor must be a power of 2, at least 2")
        if ext > 32:
            raise ValueError("extension factor cannot be greater than 32")
        self.extension_factor = ext

    @property
    def trace_register_count(self) -> int:
        return self.schema.trace_width

    @property
    def secret_input_count(self) -> int:
        return self.schema.secret_input_count

    @property
    def constraints(self):
        return self.schema.constraints

    def init_proving_context(self, inputs: Optional[Sequence] = None,
                             seed: Optional[Sequence[int]] = None, *,
                             dev=None) -> "ProvingContext":
        """`dev`: the DeviceField of the context's device tensors (the
        Stark's), for `generate_execution_trace`, `static_device` and
        `secret_register_traces`; without one, the field's CUDA card
        (`PrimeField.device`), taken when the context first needs it."""
        return ProvingContext(self, inputs or [], list(seed or []), dev=dev)

    def init_verification_context(self, input_shapes: Sequence[Sequence[int]],
                                  public_inputs: Optional[Sequence] = None
                                  ) -> "VerificationContext":
        return VerificationContext(self, input_shapes, public_inputs or [])


def _nested_shape(values, rank: int) -> List[int]:
    """Shape of a (uniform) nested input list; validates uniformity."""
    if rank == 0:
        return []
    if not isinstance(values, (list, tuple)) or not values:
        raise ValueError("input register requires a non-empty (nested) list")
    if rank == 1:
        return [len(values)]
    sub = [_nested_shape(v, rank - 1) for v in values]
    if any(s != sub[0] for s in sub):
        raise ValueError("nested input lists must be uniform")
    return [len(values)] + sub[0]


def _flatten(values, rank: int) -> List:
    if rank <= 1:
        return list(values)
    out = []
    for v in values:
        out.extend(_flatten(v, rank - 1))
    return out


def compute_input_layout(schema: AirSchema, shapes: Sequence[Sequence[int]]):
    """Given per-input-register shapes, derive each register's value span
    and the trace length (span rules documented on InputRegister).
    Returns (trace_length, spans, value counts per input register)."""
    input_regs = schema.input_registers
    if len(shapes) != len(input_regs):
        raise ValueError("input shape count mismatch")
    shape_of = {k: list(shapes[slot]) for slot, k in enumerate(input_regs)}
    children: Dict[int, List[int]] = {}
    for k in input_regs:
        reg = schema.static_registers[k]
        if len(shape_of[k]) != reg.rank:
            raise ValueError(
                f"input register {k}: shape rank {len(shape_of[k])} != declared rank {reg.rank}")
        if reg.parent is not None:
            children.setdefault(reg.parent, []).append(k)
        if reg.peer is not None and shape_of[k] != shape_of[reg.peer]:
            raise ValueError(f"peer input registers {k} and {reg.peer} must share shape")

    spans: Dict[int, int] = {}

    def span(k: int) -> int:
        if k in spans:
            return spans[k]
        reg = schema.static_registers[k]
        if reg.steps is not None:
            s = reg.steps
        elif reg.peer is not None:
            s = span(reg.peer)
        elif children.get(k):
            c0 = children[k][0]
            for c in children[k][1:]:
                if shape_of[c][-1] != shape_of[c0][-1]:
                    raise ValueError("sibling child inputs must share the last dimension")
            s = shape_of[c0][-1] * span(c0)
        else:
            s = schema.base_steps
        spans[k] = s
        return s

    totals = {}
    trace_length = schema.base_steps if not input_regs else None
    for k in input_regs:
        reg = schema.static_registers[k]
        if reg.parent is not None and shape_of[k][:-1] != shape_of[reg.parent]:
            raise ValueError(
                f"child input {k} shape must extend parent {reg.parent} shape")
        n = 1
        for d in shape_of[k]:
            n *= d
        totals[k] = n
        t = n * span(k)
        if trace_length is None:
            trace_length = t
        elif t != trace_length:
            raise ValueError(
                f"inconsistent input spans: register {k} implies trace length {t}, "
                f"others imply {trace_length}")
    return trace_length, spans, totals


class _ContextBase:
    """Domain bookkeeping shared by the proving and verification contexts."""

    def __init__(self, module: AirModule, trace_length: int):
        self.module = module
        self.schema = module.schema
        self.field = module.field
        if trace_length < 2 or trace_length & (trace_length - 1):
            raise ValueError("trace length must be a power of 2, at least 2")
        ext = module.extension_factor
        self.trace_length = trace_length
        self.extension_factor = ext
        self.evaluation_domain_size = trace_length * ext
        self.composition_domain_size = trace_length * module.composition_factor
        # generator of the evaluation domain
        self.root_of_unity = self.field.get_root_of_unity(self.evaluation_domain_size)

    @property
    def constraints(self):
        return self.schema.constraints

    @property
    def constraint_degrees(self) -> List[int]:
        return self.schema.constraint_degrees

    def _cyclic_pattern(self, k: int) -> Optional[List[int]]:
        """Periodic pattern for register k if it is cyclic-like (cycle/mask).
        Mask period = the source input register's value span; the mask is
        aligned with the shifted source column."""
        reg = self.schema.static_registers[k]
        if isinstance(reg, CyclicRegister):
            return [v % self.field.modulus for v in reg.values]
        if isinstance(reg, MaskRegister):
            span = self.input_spans[reg.source]
            src = self.schema.static_registers[reg.source]
            pattern = [0] * span
            pattern[src.shift % span] = 1
            if reg.inverted:
                pattern = [1 - v for v in pattern]
            return pattern
        return None


class ProvingContext(_ContextBase):
    def __init__(self, module: AirModule, inputs: Sequence, seed: List[int], *, dev=None):
        schema = module.schema
        self.dev = dev
        self.field = module.field
        input_regs = schema.input_registers
        if len(inputs) != len(input_regs):
            raise ValueError(
                f"expected inputs for {len(input_regs)} input registers, got {len(inputs)}")
        self.input_values: Dict[int, List[int]] = {}
        self.input_shapes: List[List[int]] = []
        for slot, k in enumerate(input_regs):
            reg: InputRegister = schema.static_registers[k]
            shape = _nested_shape(inputs[slot], reg.rank)
            values = [int(v) % self.field.modulus for v in _flatten(inputs[slot], reg.rank)]
            if reg.binary and any(v not in (0, 1) for v in values):
                raise ValueError("binary input register requires 0/1 values")
            self.input_values[k] = values
            self.input_shapes.append(shape)
        trace_length, self.input_spans, _ = compute_input_layout(schema, self.input_shapes)
        super().__init__(module, trace_length)
        self.seed = [int(s) % self.field.modulus for s in seed]
        self._trace_std = None
        self._trace = None
        # "native" or "python": which generator made this context's trace,
        # and its host seconds, the `air.trace` span's (the g++ build of a
        # new schema included)
        self.trace_source = None
        self.trace_seconds = None

    # ----- static register columns (host) ------------------------------------
    @cached_property
    def static_columns(self) -> List[List[int]]:
        """Per static register: the full column of T standard-form ints."""
        T = self.trace_length
        cols = []
        for k, reg in enumerate(self.schema.static_registers):
            pattern = self._cyclic_pattern(k)
            if pattern is not None:
                if len(pattern) > T:
                    raise ValueError(
                        f"cyclic register {k} period {len(pattern)} exceeds trace length {T}")
                cols.append(pattern * (T // len(pattern)))
            elif isinstance(reg, InputRegister):
                values = self.input_values[k]
                span = self.input_spans[k]
                expanded = [v for v in values for _ in range(span)]
                if len(expanded) != T:
                    raise ValueError("input register span does not match trace length")
                if reg.shift:
                    s = (-reg.shift) % T
                    expanded = expanded[s:] + expanded[:s] if s else expanded
                cols.append(expanded)
            else:
                raise TypeError(f"unknown static register {type(reg)}")
        return cols

    def static_column_limbs(self, k: int, L: int) -> np.ndarray:
        """Standard-form 16-bit limbs [L, T] of static column k, built from
        the distinct values (numpy tile/repeat/roll)."""
        T = self.trace_length
        reg = self.schema.static_registers[k]
        pattern = self._cyclic_pattern(k)
        if pattern is not None:
            return np.tile(ints_to_limbs(pattern, L), (1, T // len(pattern)))
        if isinstance(reg, InputRegister):
            col = np.repeat(ints_to_limbs(self.input_values[k], L),
                            self.input_spans[k], axis=1)
            if col.shape[1] != T:
                raise ValueError("input register span does not match trace length")
            return np.roll(col, reg.shift, axis=1) if reg.shift else col
        return ints_to_limbs(self.static_columns[k], L)

    def statics_std(self) -> np.ndarray:
        """All static columns as standard-form limbs, u32 [K, L, T].  The
        staged prover's (`static_device`) and the tests'; the one-fetch
        prover builds no T-length column on the host: it keeps the cyclic
        registers' evaluations and expands the input registers on the
        device (`input_values_std`, `input_gather_index`)."""
        L = self.field.params.L
        K = len(self.schema.static_registers)
        if K == 0:
            return np.zeros((0, L, self.trace_length), dtype=np.uint32)
        return np.stack([self.static_column_limbs(k, L) for k in range(K)])

    def input_values_std(self) -> np.ndarray:
        """The input registers' values, register after register (a nested
        input flattened in rank order), as standard-form limbs u32
        [L, sum of n_k]: what `input_gather_index` expands."""
        values = [v for k in self.schema.input_registers for v in self.input_values[k]]
        return ints_to_limbs(values, self.field.params.L)

    def input_gather_index(self, device) -> torch.Tensor:
        """int64 [K_in * T] on `device`, made there: entry j T + t is the
        column of `input_values_std` that input register j holds at step t,
        its value ((t + start_pos) mod T) / span (`_statics_struct`).  It
        reads only the input shapes."""
        T = self.trace_length
        t = torch.arange(T, dtype=torch.int64, device=device)
        struct = self._statics_struct()
        parts, offset = [], 0
        for k in self.schema.input_registers:
            values, span, start = struct[k]
            parts.append(offset + torch.remainder(t + start, T) // span)
            offset += len(values)
        return torch.cat(parts)

    # ----- execution trace (host) ---------------------------------------------
    def generate_execution_trace_std(self) -> np.ndarray:
        """Run the AIR on the host: standard-form limbs, u32 [R, L, T].  The
        native generator runs unless no C++ compiler exists; any other
        failure of it raises."""
        if self._trace_std is None:
            with tracing.span("air.trace") as span:
                try:
                    self._trace_std = self._generate_trace_native()
                    self.trace_source = "native"
                except NativeUnavailable:
                    self._trace_std = self._generate_trace_pyhost()
                    self.trace_source = "python"
            self.trace_seconds = span.seconds
        return self._trace_std

    def _statics_struct(self):
        """Pattern-compressed static columns for the native generator and
        `input_gather_index`: per register (values, span, start_pos) with
        column[t] = values[((t + start_pos) mod (len*span)) / span].  None
        when some register type has no compressed form (then full columns
        are used)."""
        T = self.trace_length
        out = []
        for k, reg in enumerate(self.schema.static_registers):
            pattern = self._cyclic_pattern(k)
            if pattern is not None:
                out.append((pattern, 1, 0))
            elif isinstance(reg, InputRegister):
                span = self.input_spans[k]
                if len(self.input_values[k]) * span != T:
                    raise ValueError("input register span does not match trace length")
                # col[t] = expanded[(t - shift) mod T], expanded = repeat(values, span)
                out.append((self.input_values[k], span,
                            (-reg.shift) % T if reg.shift else 0))
            else:
                return None
        return out

    def _generate_trace_native(self) -> np.ndarray:
        """Code-generated C++ recurrence (native/tracegen.py): the u32
        [R, L, T] upload layout, written by the generated code itself.
        Adds the Montgomery products it performed to
        `tracing.counters["trace_products"]`."""
        schema = self.schema
        run = native_trace_fn(schema.init, schema.transition, self.field.modulus,
                              len(self.seed), len(schema.static_registers))
        struct = self._statics_struct()
        cols = self.static_columns if struct is None else None
        T = self.trace_length
        trace = run(cols, self.seed, T, statics_struct=struct)
        tracing.counters["trace_products"] += run.init_products + run.step_products * (T - 1)
        return trace

    def _generate_trace_pyhost(self) -> np.ndarray:
        """The Python interpreter over big ints (no C++ compiler)."""
        schema = self.schema
        p = self.field.modulus
        T = self.trace_length
        R = schema.trace_width
        init_fn = compile_host_fn(schema.init, p)
        step_fn = compile_host_fn(schema.transition, p)
        cols = self.static_columns
        K = len(cols)
        statics = [[cols[k][t] for k in range(K)] for t in range(T)] if K \
            else [[]] * T
        state = init_fn([0] * R, statics[0], self.seed)
        rows = [state]
        for t in range(T - 1):
            state = step_fn(state, statics[t])
            rows.append(state)
        L = self.field.params.L
        flat = [rows[t][r] for r in range(R) for t in range(T)]
        return np.asarray(ints_to_limbs(flat, L)).reshape(
            L, R, T).transpose(1, 0, 2).copy()

    def trace_value_host(self, register: int, step: int) -> int:
        """Standard-form python int at (register, step) of the host trace."""
        col = self.generate_execution_trace_std()[register, :, step:step + 1]
        return limbs_to_ints(col)[0]

    # ----- the device trace of the staged prover ---------------------------------
    def _device(self):
        if self.dev is None:
            self.dev = self.field.device      # the card's; raises where there is none
        return self.dev

    def _to_mont_device(self, std: np.ndarray) -> torch.Tensor:
        """Standard-form u32 limbs [B, L, T] -> Montgomery [B, L, T] on the
        context's device, in one upload."""
        dev = self._device()
        x = dev.from_numpy(std)
        return dev.to_mont(x.permute(1, 0, 2)).permute(1, 0, 2).contiguous()

    def generate_execution_trace(self) -> torch.Tensor:
        """The trace as Montgomery [R, L, T] on the context's device (JAX
        `ProvingContext.generate_execution_trace`, air/module.py:300), from
        the host trace (`generate_execution_trace_std`) in one upload."""
        if self._trace is None:
            self._trace = self._to_mont_device(self.generate_execution_trace_std())
        return self._trace

    @cached_property
    def static_device(self) -> torch.Tensor:
        """[K, L, T] Montgomery static columns on the context's device (K
        may be 0; JAX air/module.py:291)."""
        statics = self.statics_std()
        if statics.shape[0] == 0:
            dev = self._device()
            return torch.zeros(statics.shape, dtype=torch.int32, device=dev.device)
        return self._to_mont_device(statics)

    @cached_property
    def secret_register_traces(self) -> List[torch.Tensor]:
        """Per secret input register, its evaluations over the evaluation
        domain, [L, Ne] Montgomery (JAX air/module.py:472)."""
        from .. import ntt
        statics = self.static_device
        return [ntt.low_degree_extend(self.field, ntt.intt(self.field, statics[k]),
                                      self.evaluation_domain_size)
                for k in self.schema.secret_input_registers]

    # ----- transition constraints over a domain ------------------------------
    def evaluate_transition_constraints(self, p_polys: torch.Tensor) -> torch.Tensor:
        """p_polys [R, L, T] coefficients (Montgomery) -> [C, L, Nc]
        constraint evaluations over the composition domain (JAX
        air/module.py:485): the LDE to Nc, the next-step roll, the static
        registers interpolated and extended, then the DAG."""
        from .. import ntt
        Nc = self.composition_domain_size
        p_evals = ntt.low_degree_extend(self.field, p_polys, Nc)
        n_evals = torch.roll(p_evals, -(Nc // self.trace_length), dims=-1)
        statics = self.static_device
        static_evals = [ntt.low_degree_extend(self.field, ntt.intt(self.field, statics[k]), Nc)
                        for k in range(statics.shape[0])]
        dev = self.field.device_field(p_polys.device)
        return self.evaluate_transition_constraints_over(dev, p_evals, n_evals, static_evals)

    def evaluate_transition_constraints_over(self, dev, p_evals: torch.Tensor,
                                             n_evals: torch.Tensor,
                                             static_evals) -> torch.Tensor:
        """Constraint-DAG evaluation over any domain (JAX
        `evaluate_transition_constraints_traced`, air/module.py:505):
        p_evals / n_evals [R, L, N], static_evals list of [L, N], all
        Montgomery -> [C, L, N]."""
        schema = self.schema
        env = {"dev": dev, "ndim": 1,
               "trace": [p_evals[r] for r in range(schema.trace_width)],
               "next": [n_evals[r] for r in range(schema.trace_width)],
               "static": list(static_evals)}
        cache = {}
        return torch.stack([eval_device(c, env, cache) for c in schema.constraints])


class VerificationContext(_ContextBase):
    """The verifier's context: domains from the proof's input shapes, and
    the static registers evaluated at one point (cyclic and public input
    registers interpolated on the host, secret ones from the proof)."""

    def __init__(self, module: AirModule, input_shapes: Sequence[Sequence[int]],
                 public_inputs: Sequence):
        schema = module.schema
        self.field = module.field
        input_regs = schema.input_registers
        public_regs = [k for k in input_regs if not schema.static_registers[k].secret]
        if len(public_inputs) != len(public_regs):
            raise ValueError(
                f"expected {len(public_regs)} public inputs, got {len(public_inputs)}")
        self.input_shapes = [list(s) for s in input_shapes]
        trace_length, self.input_spans, counts = compute_input_layout(
            schema, self.input_shapes)
        super().__init__(module, trace_length)
        self.public_input_values: Dict[int, List[int]] = {}
        for slot, k in enumerate(public_regs):
            reg: InputRegister = schema.static_registers[k]
            values = [int(v) % self.field.modulus
                      for v in _flatten(public_inputs[slot], reg.rank)]
            if len(values) != counts[k]:
                raise ValueError("public input length does not match input shape")
            self.public_input_values[k] = values

    @cached_property
    def _static_evaluators(self):
        """Per static register: ('secret', slot) or ('eval', x -> value)."""
        f = self.field.host
        T = self.trace_length
        evaluators = []
        secret_slot = 0
        for k, reg in enumerate(self.schema.static_registers):
            pattern = self._cyclic_pattern(k)
            if isinstance(reg, InputRegister) and reg.secret:
                evaluators.append(("secret", secret_slot))
                secret_slot += 1
                continue
            if pattern is not None:
                ell = len(pattern)
                coeffs = f.interpolate_roots(pattern) if ell > 1 else list(pattern)
                power = T // ell

                def make_cyclic(coeffs=coeffs, power=power):
                    return lambda x: f.eval_poly_at(coeffs, f.exp(x, power))
                evaluators.append(("eval", make_cyclic()))
            else:
                # public input register: interpolate the full expanded column
                values = self.public_input_values[k]
                span = self.input_spans[k]
                expanded = [v for v in values for _ in range(span)]
                if reg.shift:
                    s = (-reg.shift) % T
                    expanded = expanded[s:] + expanded[:s]
                coeffs = f.interpolate_roots(expanded)

                def make_full(coeffs=coeffs):
                    return lambda x: f.eval_poly_at(coeffs, x)
                evaluators.append(("eval", make_full()))
        return evaluators

    def evaluate_constraints_at(self, x: int, p_values: List[int],
                                n_values: List[int], s_values: List[int]) -> List[int]:
        """Single-point constraint evaluation on the host; s_values are the
        committed secret-register values from the proof."""
        static_vals = []
        for kind, payload in self._static_evaluators:
            static_vals.append(s_values[payload] if kind == "secret" else payload(x))
        env = {"field": self.field.host, "trace": p_values, "next": n_values,
               "static": static_vals}
        cache = {}
        return [eval_host(c, env, cache) for c in self.schema.constraints]
