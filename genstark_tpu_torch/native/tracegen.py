"""C++ code generation for execution-trace recurrences.

Counterpart of ``genstark_tpu/native/tracegen.py`` (a copy with its own
output layout, build directory and failure rules).  Emits one translation
unit per (AIR schema, modulus) with:

- 64-bit-limb Montgomery arithmetic (CIOS with ``unsigned __int128``
  partial products) whose parameters are baked in as compile-time constants;
- ``init`` / ``step`` functions generated from the AIR expression DAG
  (common subexpressions emitted once, static exponents unrolled as
  square-and-multiply, division via a Fermat ladder with the baked p-2);
- an ``extern "C"`` entry running the full T-step recurrence.

The recurrence is serial over tiny state, so it runs at native host speed
while every batched domain-wide stage runs on the device.

Interface: static registers enter PATTERN-COMPRESSED — each register k is
(values[ell_k] standard-form u64 limbs, span_k, start_pos_k) with
column[t] = values[((t + start_pos) mod (ell*span)) / span] — so the wrapper
never materializes full columns and the C++ converts each pattern value to
Montgomery once.  The trace is written directly in the prover's upload
layout, uint32[R][L][T] standard-form 16-bit limbs (one limb a word; L =
element_size / 2), so the host does no re-layout between the recurrence and
the device transfer:

    int genstark_trace(const uint64_t* patterns, // [sum ell_k][LC] std form
                       const uint64_t* meta,     // [K][3]: ell, span, start
                       const uint64_t* seed,     // [S][LC]
                       uint64_t T,
                       uint32_t* out)            // [R][L16][T]

Shared objects are built with ``g++ -O3 -shared`` into
``genstark_tpu_torch/_build/native/``, one per hash of the generated source.
`NativeUnavailable` is raised only when no C++ compiler exists (the caller
then runs the Python interpreter); a codegen error or a failed build on a
working toolchain raises `NativeCompileError` or the codegen's own error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from typing import Dict, List, Sequence

import numpy as np

from ..air.ir import (Add, Const, Div, Exp, Expr, Mul, Neg, SeedVal, StaticReg,
                      Sub, TraceReg)

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build", "native")
CXX = "g++"
# Seconds each shared object took to build in this process, by file name.
build_seconds: Dict[str, float] = {}


class NativeUnavailable(RuntimeError):
    """No C++ compiler on this host: the Python interpreter takes over."""


class NativeCompileError(RuntimeError):
    """The compiler exists but refused the generated source."""


def _u64_limbs(value: int, lc: int) -> List[int]:
    return [(value >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(lc)]


def _fe_literal(value: int, lc: int) -> str:
    limbs = ", ".join(f"{v}ull" for v in _u64_limbs(value, lc))
    return "{" + limbs + "}"


def _emit_exprs(exprs: Sequence[Expr], p: int, lc: int, *, seed_count: int,
                is_init: bool) -> str:
    """Generated C++ body computing `exprs` into out[0..R-1] (Montgomery).

    Scope: cur[] (current trace registers), st[] (static registers at the
    step), sd[] (seed params, init only).  All in Montgomery form.
    """
    lines: List[str] = []
    names: Dict[int, str] = {}
    consts: Dict[int, str] = {}
    counter = [0]

    def const_name(v: int) -> str:
        v %= p
        if v not in consts:
            # constant baked in Montgomery form (v * R mod p)
            mont = (v << (64 * lc)) % p
            name = f"c{len(consts)}"
            lines.insert(0, f"  static const fe {name} = {_fe_literal(mont, lc)};")
            consts[v] = name
        return consts[v]

    def emit(expr: Expr) -> str:
        key = id(expr)
        if key in names:
            return names[key]
        if isinstance(expr, Const):
            name = const_name(expr.value)
        elif isinstance(expr, TraceReg):
            name = f"cur[{expr.index}]"
        elif isinstance(expr, StaticReg):
            name = f"st[{expr.index}]"
        elif isinstance(expr, SeedVal):
            if not is_init:
                raise ValueError("seed reference outside init")
            if expr.index >= seed_count:
                raise ValueError("seed index out of range")
            name = f"sd[{expr.index}]"
        else:
            name = f"v{counter[0]}"
            counter[0] += 1
            if isinstance(expr, Add):
                lines.append(f"  fe {name} = fadd({emit(expr.a)}, {emit(expr.b)});")
            elif isinstance(expr, Sub):
                lines.append(f"  fe {name} = fsub({emit(expr.a)}, {emit(expr.b)});")
            elif isinstance(expr, Mul):
                lines.append(f"  fe {name} = fmul({emit(expr.a)}, {emit(expr.b)});")
            elif isinstance(expr, Div):
                lines.append(f"  fe {name} = fmul({emit(expr.a)}, finv({emit(expr.b)}));")
            elif isinstance(expr, Neg):
                lines.append(f"  fe {name} = fsub(FE_ZERO, {emit(expr.a)});")
            elif isinstance(expr, Exp):
                base = emit(expr.a)
                e = expr.e % (p - 1) if p > 2 else expr.e
                if e == 0:
                    name = "FE_ONE_M"
                elif e == 1:
                    name = base
                else:
                    # square-and-multiply unrolled at codegen time
                    sq, acc = base, None
                    while e:
                        if e & 1:
                            if acc is None:
                                acc = sq
                            else:
                                nm = f"v{counter[0]}"; counter[0] += 1
                                lines.append(f"  fe {nm} = fmul({acc}, {sq});")
                                acc = nm
                        e >>= 1
                        if e:
                            nm = f"v{counter[0]}"; counter[0] += 1
                            lines.append(f"  fe {nm} = fmul({sq}, {sq});")
                            sq = nm
                    name = acc
            else:
                raise TypeError(f"unknown expr node {type(expr)}")
        names[key] = name
        return name

    outs = [emit(e) for e in exprs]
    for r, o in enumerate(outs):
        lines.append(f"  out[{r}] = {o};")
    return "\n".join(lines)


def _generate_source(init: Sequence[Expr], transition: Sequence[Expr],
                     p: int, seed_count: int, n_static: int) -> str:
    lc = max(1, (p.bit_length() + 63) // 64)
    l16 = 2 * max(1, (p.bit_length() + 31) // 32)   # device 16-bit limb count
    r2 = (1 << (128 * lc)) % p
    one_m = (1 << (64 * lc)) % p
    n0p = (-pow(p, -1, 1 << 64)) % (1 << 64)
    R = len(transition)
    init_body = _emit_exprs(init, p, lc, seed_count=seed_count, is_init=True)
    step_body = _emit_exprs(transition, p, lc, seed_count=seed_count, is_init=False)
    pm2 = p - 2

    return f"""// generated by genstark_tpu_torch.native.tracegen — do not edit
#include <cstdint>
#include <cstring>

namespace {{

constexpr int LC  = {lc};
constexpr int L16 = {l16};   // device 16-bit limbs per element (<= 4*LC)
constexpr int R   = {R};
constexpr int K   = {n_static};
constexpr int S   = {seed_count};

struct fe {{ uint64_t v[LC]; }};

static const fe P        = {_fe_literal(p, lc)};
static const fe R2       = {_fe_literal(r2, lc)};
static const fe FE_ZERO  = {_fe_literal(0, lc)};
static const fe FE_ONE_M = {_fe_literal(one_m, lc)};   // Montgomery 1
static const fe PM2      = {_fe_literal(pm2, lc)};     // exponent p-2
constexpr uint64_t N0P = {n0p}ull;

static inline bool geq_p(const uint64_t* t) {{
  for (int i = LC - 1; i >= 0; --i) {{
    if (t[i] > P.v[i]) return true;
    if (t[i] < P.v[i]) return false;
  }}
  return true;  // equal
}}

static inline void sub_p(uint64_t* t) {{
  unsigned __int128 borrow = 0;
  for (int i = 0; i < LC; ++i) {{
    unsigned __int128 d = (unsigned __int128)t[i] - P.v[i] - borrow;
    t[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }}
}}

static inline fe fadd(const fe& a, const fe& b) {{
  fe r; unsigned __int128 c = 0;
  for (int i = 0; i < LC; ++i) {{
    c += (unsigned __int128)a.v[i] + b.v[i];
    r.v[i] = (uint64_t)c; c >>= 64;
  }}
  if (c || geq_p(r.v)) sub_p(r.v);
  return r;
}}

static inline fe fsub(const fe& a, const fe& b) {{
  fe r; unsigned __int128 borrow = 0;
  for (int i = 0; i < LC; ++i) {{
    unsigned __int128 d = (unsigned __int128)a.v[i] - b.v[i] - borrow;
    r.v[i] = (uint64_t)d; borrow = (d >> 64) ? 1 : 0;
  }}
  if (borrow) {{
    unsigned __int128 c = 0;
    for (int i = 0; i < LC; ++i) {{
      c += (unsigned __int128)r.v[i] + P.v[i];
      r.v[i] = (uint64_t)c; c >>= 64;
    }}
  }}
  return r;
}}

// CIOS Montgomery multiplication: returns a*b*R^-1 mod p, R = 2^(64*LC).
static inline fe fmul(const fe& a, const fe& b) {{
  uint64_t t[LC + 2] = {{0}};
  for (int i = 0; i < LC; ++i) {{
    unsigned __int128 c = 0;
    for (int j = 0; j < LC; ++j) {{
      c += (unsigned __int128)a.v[j] * b.v[i] + t[j];
      t[j] = (uint64_t)c; c >>= 64;
    }}
    c += t[LC]; t[LC] = (uint64_t)c; t[LC + 1] = (uint64_t)(c >> 64);
    uint64_t m = t[0] * N0P;
    c = (unsigned __int128)m * P.v[0] + t[0]; c >>= 64;
    for (int j = 1; j < LC; ++j) {{
      c += (unsigned __int128)m * P.v[j] + t[j];
      t[j - 1] = (uint64_t)c; c >>= 64;
    }}
    c += t[LC]; t[LC - 1] = (uint64_t)c;
    t[LC] = t[LC + 1] + (uint64_t)(c >> 64);
  }}
  fe r;
  std::memcpy(r.v, t, sizeof(r.v));
  if (t[LC] || geq_p(r.v)) sub_p(r.v);
  return r;
}}

static inline fe fpow_pm2(const fe& a) {{      // a^(p-2): Fermat inverse
  fe acc = FE_ONE_M, sq = a;
  for (int i = 0; i < 64 * LC; ++i) {{
    if ((PM2.v[i / 64] >> (i % 64)) & 1) acc = fmul(acc, sq);
    sq = fmul(sq, sq);
  }}
  return acc;
}}

static inline fe finv(const fe& a) {{          // inv(0) = 0 (galois convention)
  bool zero = true;
  for (int i = 0; i < LC; ++i) if (a.v[i]) {{ zero = false; break; }}
  return zero ? FE_ZERO : fpow_pm2(a);
}}

static const fe FE_ONE_STD = {_fe_literal(1, lc)};    // literal 1 (not Montgomery)
static inline fe to_mont(const fe& a)   {{ return fmul(a, R2); }}
static inline fe from_mont(const fe& a) {{ return fmul(a, FE_ONE_STD); }}

static void init_fn(const fe* cur, const fe* st, const fe* sd, fe* out) {{
  (void)cur; (void)st; (void)sd;
{init_body}
}}

static void step_fn(const fe* cur, const fe* st, fe* out) {{
  (void)cur; (void)st;
{step_body}
}}

static inline void emit_row(uint32_t* out, uint64_t t, uint64_t T,
                            const fe* cur) {{
  // out[r][i][t] = 16-bit limb i of standard-form register r, one limb a
  // 32-bit word: the prover's upload layout, handed to the device as is
  for (int r = 0; r < R; ++r) {{
    fe s = from_mont(cur[r]);
    uint32_t* base = out + (uint64_t)r * L16 * T + t;
    for (int i = 0; i < L16; ++i)
      base[(uint64_t)i * T] = (uint32_t)((s.v[i / 4] >> (16 * (i % 4))) & 0xFFFFu);
  }}
}}

// Pattern-compressed static register stream: column[t] =
// values[((t + start) mod (ell*span)) / span], with every pattern value
// converted to Montgomery exactly once.
struct StaticStream {{
  const fe* vals;      // [ell], Montgomery
  uint64_t ell, span, idx, scnt;
  inline fe get() const {{ return vals[idx]; }}
  inline void advance() {{
    if (++scnt == span) {{
      scnt = 0;
      if (++idx == ell) idx = 0;
    }}
  }}
}};

}}  // namespace

extern "C" int genstark_trace(const uint64_t* patterns, const uint64_t* meta,
                              const uint64_t* seed, uint64_t T,
                              uint32_t* out) {{
  fe sd[S > 0 ? S : 1];
  for (int i = 0; i < S; ++i) {{
    std::memcpy(sd[i].v, seed + i * LC, sizeof(fe));
    sd[i] = to_mont(sd[i]);
  }}
  uint64_t total = 0;
  for (int k = 0; k < K; ++k) total += meta[3 * k];
  fe* pat = new fe[total > 0 ? total : 1];
  for (uint64_t j = 0; j < total; ++j) {{
    std::memcpy(pat[j].v, patterns + j * LC, sizeof(fe));
    pat[j] = to_mont(pat[j]);
  }}
  StaticStream ss[K > 0 ? K : 1];
  uint64_t off = 0;
  for (int k = 0; k < K; ++k) {{
    uint64_t ell = meta[3 * k], span = meta[3 * k + 1], start = meta[3 * k + 2];
    ss[k] = StaticStream{{pat + off, ell, span,
                          (start / span) % ell, start % span}};
    off += ell;
  }}
  fe cur[R], nxt[R];
  fe st[K > 0 ? K : 1];
  for (int k = 0; k < K; ++k) st[k] = ss[k].get();
  fe zero_regs[R];
  for (int r = 0; r < R; ++r) zero_regs[r] = FE_ZERO;
  init_fn(zero_regs, st, sd, cur);
  emit_row(out, 0, T, cur);
  for (uint64_t t = 0; t + 1 < T; ++t) {{
    step_fn(cur, st, nxt);
    for (int k = 0; k < K; ++k) {{
      ss[k].advance();
      st[k] = ss[k].get();
    }}
    for (int r = 0; r < R; ++r) cur[r] = nxt[r];
    emit_row(out, t + 1, T, cur);
  }}
  delete[] pat;
  return 0;
}}
"""


@lru_cache(maxsize=None)
def _compile(source: str) -> str:
    """Compile the generated source into a shared object under BUILD_DIR,
    named by the source's hash; returns its path."""
    if shutil.which(CXX) is None:
        raise NativeUnavailable(f"no C++ compiler ({CXX}) on this host")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = hashlib.sha256(source.encode()).hexdigest()[:24]
    so_path = os.path.join(BUILD_DIR, f"trace_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    # per-pid names: concurrent test workers may compile the same source, and
    # a shared temp path would interleave two g++ writes into one corrupt .so
    src_path = os.path.join(BUILD_DIR, f"trace_{tag}.{os.getpid()}.cpp")
    with open(src_path, "w") as fh:
        fh.write(source)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    t0 = time.monotonic()
    run = subprocess.run([CXX, "-O3", "-shared", "-fPIC", "-o", tmp, src_path],
                         capture_output=True, timeout=300)
    if run.returncode != 0:
        raise NativeCompileError(f"{CXX} failed ({run.returncode}): "
                               f"{run.stderr.decode(errors='replace')[:2000]}")
    os.replace(tmp, so_path)
    os.remove(src_path)
    build_seconds[os.path.basename(so_path)] = time.monotonic() - t0
    return so_path


@lru_cache(maxsize=None)
def _entry(so_path: str):
    """The `genstark_trace` entry of a built shared object, loaded once (a
    CDLL and its function pointers form a reference cycle, so a load per
    prove would leave garbage for the cyclic collector)."""
    fn = ctypes.CDLL(so_path).genstark_trace
    fn.restype = ctypes.c_int
    # addresses as plain ints (ndarray.ctypes.data): a data_as pointer and
    # its array form a reference cycle too
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                   ctypes.c_void_p]
    return fn


def _ints_to_u64_limbs(values: Sequence[int], lc: int) -> np.ndarray:
    """[N, lc] u64 little-endian limbs of standard-form ints."""
    raw = b"".join(int(v).to_bytes(8 * lc, "little") for v in values)
    return np.frombuffer(raw, dtype="<u8").reshape(len(values), lc) \
        .astype(np.uint64)


def native_trace_fn(init: Sequence[Expr], transition: Sequence[Expr], p: int,
                    seed_count: int, n_static: int):
    """Build (or load from cache) the native trace function for one schema.

    Returns ``run(static_cols, seed, T, statics_struct=None) ->
    np.uint32[R, L16, T]`` — standard-form 16-bit limbs, one a word, in the
    prover's upload layout.  ``statics_struct`` is the pattern-compressed
    form: per register a (values, span, start_pos) triple with
    column[t] = values[((t + start_pos) mod (len*span)) / span]; when None,
    ``static_cols`` full columns are compressed trivially (ell=T, span=1).
    Raises NativeUnavailable when there is no C++ compiler, and
    NativeCompileError (or the codegen's own error) on any other failure.
    """
    fn = _entry(_compile(_generate_source(init, transition, p, seed_count, n_static)))
    lc = max(1, (p.bit_length() + 63) // 64)
    l16 = 2 * max(1, (p.bit_length() + 31) // 32)
    R = len(transition)

    def run(static_cols, seed: Sequence[int], T: int, statics_struct=None):
        if statics_struct is None:
            statics_struct = [(list(col), 1, 0) for col in (static_cols or [])]
        K = len(statics_struct)
        if K != n_static:
            raise ValueError(f"{K} static registers given, the schema has {n_static}")
        meta = np.zeros((max(K, 1), 3), dtype=np.uint64)
        pats = []
        for k, (vals, span, start) in enumerate(statics_struct):
            meta[k] = (len(vals), span, start)
            pats.append(_ints_to_u64_limbs(vals, lc))
        patterns = (np.concatenate(pats, axis=0) if pats
                    else np.zeros((1, lc), dtype=np.uint64))
        seed_arr = np.zeros((max(seed_count, 1), lc), dtype=np.uint64)
        if seed:
            seed_arr[:len(seed)] = _ints_to_u64_limbs(seed, lc)
        out = np.empty((R, l16, T), dtype=np.uint32)
        rc = fn(patterns.ctypes.data, meta.ctypes.data, seed_arr.ctypes.data,
                ctypes.c_uint64(T),
                out.ctypes.data)
        if rc != 0:
            raise NativeCompileError(f"native trace returned {rc}")
        return out

    return run
