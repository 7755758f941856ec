"""Build, load and launch the port's CUDA kernels.

The kernels live in ``csrc/`` (dft_level.cu, hash.cu, lcomb_tail.cu,
field_ops.cu, butterfly.cu, butterfly_stage.cu, probes.cu, queries.cu,
sharing field.cuh).  At first use each source is
compiled by its own ``nvcc`` for ``sm_90a`` (all started together), and the
objects are linked into ONE shared library with a plain C interface, under
``_build/<hash of the sources>/``, loaded with ctypes.  Nothing is built or
imported when this module is imported.

Each wrapper below checks device, dtype, shape and layout, launches on the
current CUDA stream, raises if the launch failed, and adds one to its entry
in ``launch_counts``.  The wrappers take CUDA tensors only: the modules that
own a kernel (field/device.py, ntt/dft.py, ntt/radix2.py, hash/__init__.py,
protocol/lincomb_kernel.py, protocol/device_queries.py, roofline.py) send
CPU tensors to their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_SOURCES = ("dft_level.cu", "hash.cu", "lcomb_tail.cu", "field_ops.cu", "butterfly.cu",
            "butterfly_stage.cu", "probes.cu", "queries.cu")
_HEADERS = ("field.cuh",)
_LIB_NAME = "libgenstark_kernels.so"

# Limb counts the field kernels are instantiated for (p32, p64, p128, p224,
# p256).
FIELD_LS = (2, 4, 8, 14, 16)
# Elementwise kernel: batch dimensions after coalescing.
EW_MAX_DIMS = 4
# Shared memory a block may opt in to (227 KB): kernel 8 holds a whole local
# transform and its twiddles there, kernels 7/9 a tile of 2^k x 16 elements.
SMEM_BYTES = 232448

# Launch counts per kernel (kernel 1: dft_level; 2: hash_words; 3:
# hash_limbs; 4: lcomb_tail; 5: field_ew; 6: outer_table; 7: bfly_stage; 8:
# butterfly; 9: bfly_stage_split; 10: mont_chain; 11: u32_chain; and the
# port's kernels without a Pallas row, A: mont_inv; B: sample_queries).  A
# wrapper adds one where it launches.
launch_counts = {"dft_level": 0, "hash_words": 0, "hash_limbs": 0, "lcomb_tail": 0,
                 "field_ew": 0, "outer_table": 0, "bfly_stage": 0, "butterfly": 0,
                 "bfly_stage_split": 0, "mont_chain": 0, "u32_chain": 0, "mont_inv": 0,
                 "sample_queries": 0}
# The JAX package's rule between rows 7 and 9 (pallas_kernels.py:378, _BLK):
# a pass whose lowest stage has half-size m <= STAGE_SPLIT_ABOVE counts as
# row 7.
STAGE_SPLIT_ABOVE = 4096
# Kernels 7/9: a tile is 16 columns wide, so a pass's lowest half-size m is
# at least 16 (the direct route's is LOCAL_MAX = 2048).
STAGE_MIN_M = 16

_lib = None
build_info = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _HEADERS + _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build() -> str:
    """Compile the kernels (once per source hash) and return the library
    path: one nvcc per source, all running at once, then one link.  Records
    the build seconds and the compiler's register report in `build_info`
    (for a library built before, the report its build wrote)."""
    out_dir = os.path.join(_BUILD, _source_hash())
    lib_path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(lib_path):
        build_info.setdefault("seconds", 0.0)
        if "log" not in build_info:
            with open(os.path.join(out_dir, "build.log")) as fh:
                build_info["log"] = fh.read()
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    objs = [os.path.join(out_dir, f"{src}.{tag}.o") for src in _SOURCES]
    cmds = [[nvcc] + flags + ["-Xptxas", "-v", "-c", "-o", obj, os.path.join(_CSRC, src)]
            for src, obj in zip(_SOURCES, objs)]
    t0 = time.monotonic()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [src for src, p in zip(_SOURCES, procs) if p.returncode != 0]
    tmp = f"{lib_path}.{tag}"
    link = [nvcc] + flags + ["-shared", "-o", tmp] + objs
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append("link")
    build_info["seconds"] = time.monotonic() - t0
    build_info["log"] = "\n".join(logs)
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        fh.write("\n".join(" ".join(c) for c in cmds + [link]) + "\n" + build_info["log"])
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_info['log'][-6000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gs_dft_level.argtypes = [I, P, P, P, I, I, I, I, I, I, P, P, I, I, I, I, P, P, P, I,
                                     P]
        lib.gs_dft_level.restype = I
        lib.gs_hash_words.argtypes = [I, P, I, I, LL, P, P]
        lib.gs_hash_words.restype = I
        lib.gs_hash_limbs.argtypes = [I, P, I, I, I, LL, P, P]
        lib.gs_hash_limbs.restype = I
        lib.gs_lcomb_tail.argtypes = [I, P, P, P, P, P]
        lib.gs_lcomb_tail.restype = I
        lib.gs_field_ew.argtypes = [I, I, P, P, P, P, P, I, P, P, P]
        lib.gs_field_ew.restype = I
        lib.gs_outer_table.argtypes = [I, P, I, P, I, P, P, P]
        lib.gs_outer_table.restype = I
        lib.gs_butterfly.argtypes = [I, P, P, P, P, P, I, I, I, I, P, P]
        lib.gs_butterfly.restype = I
        lib.gs_butterfly_stages.argtypes = [I, P, P, I, I, I, I, P, P]
        lib.gs_butterfly_stages.restype = I
        lib.gs_mont_chain.argtypes = [I, P, P, LL, I, P, P]
        lib.gs_mont_chain.restype = I
        lib.gs_u32_chain.argtypes = [P, P, LL, I, P]
        lib.gs_u32_chain.restype = I
        lib.gs_mont_inv.argtypes = [I, P, P, LL, P, I, P, P]
        lib.gs_mont_inv.restype = I
        lib.gs_sample_queries.argtypes = [P, I, P, P, P, P, I, I, P, P, P]
        lib.gs_sample_queries.restype = I
        _lib = lib
    return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def _require(t: torch.Tensor, what: str, dtype, shape=None, contiguous: bool = True) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _field_words(dev) -> np.ndarray:
    """p limbs [L], then n0' = -p^-1 mod 2^32 (field.cuh `FieldW`, the word
    product): L + 1 words."""
    return np.concatenate([dev.params.p_limbs.astype(np.uint32),
                           np.asarray([dev.params.n0p32], dtype=np.uint32)])


def _u32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _i64s(values):
    return (ctypes.c_longlong * max(1, len(values)))(*values)


def _field_l(dev) -> int:
    if dev.L not in FIELD_LS:
        raise ValueError(f"the field kernels take L in {FIELD_LS}, not {dev.L}")
    return dev.L


# ----------------------------------------------------------------- kernel 1
# Contraction depth kernel 1 stages at once (csrc/dft_level.cu kDftSlice):
# each slice adds its own bias per diagonal, which the correction cancels.
DFT_SLICE = 64


def dft_level(dev, w8, x, m: int, rest: int, tw, out_digits: bool):
    """Kernel 1 (csrc/dft_level.cu): contract of ntt.dft.run_dft_level_ref.
    x is int8 digit planes [D, m, cols] or [D, pre, m, r], or int32
    canonical limbs [L, m, cols] or [L, pre, m, r] (the kernel encodes
    their digits), any strides; col = b * r + q for the 4-D views."""
    from .ntt.dft import bias_correction, epilogue_constants
    L = dev.L
    D = 2 * L + 1
    _require(w8, "w8", torch.int8, (D, m, m))
    if x.device.type != "cuda":
        raise ValueError(f"x: expected a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"x: expected int8 digits or int32 limbs, got {x.dtype}")
    in_limbs = x.dtype == torch.int32
    planes = L if in_limbs else D
    if x.dim() == 3 and tuple(x.shape[:2]) == (planes, m):
        cols = x.shape[2]
        strides, arest = (x.stride(0), 0, x.stride(1), x.stride(2)), max(cols, 1)
    elif x.dim() == 4 and x.shape[0] == planes and x.shape[2] == m:
        cols = x.shape[1] * x.shape[3]
        strides, arest = (x.stride(0), x.stride(1), x.stride(2), x.stride(3)), x.shape[3]
    else:
        raise ValueError(f"x: expected [{planes}, {m}, cols] or [{planes}, pre, {m}, r], "
                         f"got {tuple(x.shape)}")
    if cols >= 1 << 31:
        raise ValueError(f"dft_level takes fewer than 2^31 columns, got {cols}")
    if min(strides) < 0:
        raise ValueError("dft_level takes views with non-negative strides")
    mode, tw_a, tw_b, s, tc = 0, None, None, 1, 1
    if rest > 1:
        if cols % rest:
            raise ValueError(f"cols={cols} is not a multiple of rest={rest}")
        if "p" in tw:
            mode, tw_a = 1, tw["p"]
            tc = tw_a.shape[2]
            _require(tw_a, "panel", torch.int32, (L, m, tc))
            if tc < rest:
                raise ValueError("direct panel narrower than rest")
        else:
            mode, tw_a, tw_b = 2, tw["a"], tw["b"]
            s = tw_b.shape[2]
            _require(tw_a, "twiddle A", torch.int32, (rest // s, L, m))
            _require(tw_b, "twiddle B", torch.int32, (L, m, s))
    n_out = D if out_digits else L
    out = torch.empty((n_out, m, cols), dtype=torch.int8 if out_digits else torch.int32,
                      device=x.device)
    if cols == 0:
        return out
    n_slices = -(-m // DFT_SLICE)
    _, consts = epilogue_constants(dev.p)
    epi = np.ascontiguousarray(np.concatenate(
        [bias_correction(dev.p, n_slices), consts.reshape(-1)]).astype(np.uint32))
    fw = np.ascontiguousarray(_field_words(dev))
    rc = _load().gs_dft_level(
        L, w8.data_ptr(), x.data_ptr(), _i64s(list(strides)), arest, int(in_limbs), m, cols,
        n_slices, mode, tw_a.data_ptr() if tw_a is not None else None,
        tw_b.data_ptr() if tw_b is not None else None,
        max(rest, 1), s, tc, int(out_digits), out.data_ptr(),
        _u32p(fw), _u32p(epi), consts.shape[0], _stream(x))
    _check(rc, "dft_level")
    launch_counts["dft_level"] += 1
    return out


# -------------------------------------------------------------- kernels 2, 3
_ALGO = {"sha256": 0, "blake2s256": 1}


def hash_words(algorithm: str, words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """Kernel 2 (csrc/hash.cu gs_hash_words): int32 [W, B] LE words ->
    int32 [8, B] digests."""
    n_words, batch = words.shape
    _require(words, "words", torch.int32)
    if msg_bytes != 4 * n_words:
        raise ValueError("hash_words takes whole-word messages")
    out = torch.empty((8, batch), dtype=torch.int32, device=words.device)
    rc = _load().gs_hash_words(_ALGO[algorithm], words.data_ptr(), n_words,
                               msg_bytes, batch, out.data_ptr(), _stream(words))
    _check(rc, "hash_words")
    launch_counts["hash_words"] += 1
    return out


def hash_limbs(algorithm: str, values: torch.Tensor, rows: bool) -> torch.Tensor:
    """Kernel 3 (csrc/hash.cu gs_hash_limbs), messages built from
    standard-form limbs, int32 [8, B] digests.  Leaves (`rows` false):
    values [V, L, N] contiguous, message b = LE bytes of values[0][:, b] ||
    values[1][:, b] || ...  Stride-4 rows: values [L, N] contiguous, N % 4
    == 0, message r = v[r] || v[r + M] || v[r + 2M] || v[r + 3M], M = N/4.
    Rows and leaves of 1, 2 or 4 vectors run the kernel's compile-time
    form, leaves of any other count its runtime form."""
    _require(values, "limbs", torch.int32)
    if rows:
        if values.dim() != 2 or values.shape[1] % 4:
            raise ValueError(f"stride-4 rows take values [L, N] with N % 4 == 0, "
                             f"got {tuple(values.shape)}")
        n_vec, (L, N) = 4, values.shape
        batch = N // 4
    else:
        if values.dim() != 3 or values.shape[0] < 1:
            raise ValueError(f"leaves take values [V, L, N], got {tuple(values.shape)}")
        n_vec, L, batch = values.shape
    if L not in FIELD_LS:
        raise ValueError(f"hash_limbs takes L in {FIELD_LS}, not {L}")
    out = torch.empty((8, batch), dtype=torch.int32, device=values.device)
    rc = _load().gs_hash_limbs(_ALGO[algorithm], values.data_ptr(), n_vec, L, int(rows), batch,
                               out.data_ptr(), _stream(values))
    _check(rc, "hash_limbs")
    launch_counts["hash_limbs"] += 1
    return out


# ----------------------------------------------------------------- kernel 4
def lcomb_tail(dev, qe, b_stack, e_std, dom_parts, incr_parts, inv_series,
               x_last_mont_limbs: np.ndarray, b_coeffs, l_coeffs,
               b_inc: bool, ps_inc: bool, ext: int) -> torch.Tensor:
    """Kernel 4 (csrc/lcomb_tail.cu): contract of
    protocol.lincomb_kernel.lcomb_tail_ref, with one limit: a block holds
    x_last, the coefficients and the inv series in shared memory, so
    (1 + nb + nl + ext) elements of L/2 words must fit in SMEM_BYTES."""
    L, Ne = qe.shape
    B, V = b_stack.shape[0], e_std.shape[0]
    dom_o, dom_i = dom_parts
    nj, s = dom_o.shape[1], dom_i.shape[1]
    if nj * s != Ne:
        raise ValueError("factored domain table does not cover Ne")
    nb, nl = b_coeffs.shape[1], l_coeffs.shape[1]
    if nb != B * (2 if b_inc else 1) or nl != V * (2 if ps_inc else 1):
        raise ValueError("coefficient counts do not match the vectors")
    if (1 + nb + nl + ext) * (L // 2) * 4 > SMEM_BYTES:
        raise ValueError(f"lcomb_tail's constants ({1 + nb + nl + ext} elements of {L} limbs) "
                         f"exceed the {SMEM_BYTES} bytes of shared memory a block may hold")
    if (b_inc or ps_inc) and incr_parts is None:
        raise ValueError("raised copies need the incr table")
    _require(qe, "qe", torch.int32, (L, Ne))
    _require(b_stack, "b", torch.int32, (B, L, Ne))
    _require(e_std, "e", torch.int32, (V, L, Ne))
    _require(dom_o, "dom outer", torch.int32, (L, nj))
    _require(dom_i, "dom inner", torch.int32, (L, s))
    if incr_parts is not None:
        _require(incr_parts[0], "incr outer", torch.int32, (L, nj))
        _require(incr_parts[1], "incr inner", torch.int32, (L, s))
    _require(inv_series, "inv series", torch.int32, (L, ext))
    _require(b_coeffs, "b coeffs", torch.int32, (L, nb))
    _require(l_coeffs, "l coeffs", torch.int32, (L, nl))
    out = torch.empty((L, Ne), dtype=torch.int32, device=qe.device)
    tensors = [qe, b_stack if B else None, e_std, dom_o, dom_i,
               incr_parts[0] if incr_parts is not None else None,
               incr_parts[1] if incr_parts is not None else None,
               inv_series, b_coeffs, l_coeffs, out]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[t.data_ptr() if t is not None else None for t in tensors])
    dims = (ctypes.c_longlong * 10)(Ne, nj, s, ext, B, V, nb, nl, int(b_inc), int(ps_inc))
    fw = np.ascontiguousarray(_field_words(dev))
    xl = np.ascontiguousarray(np.asarray(x_last_mont_limbs, dtype=np.uint32))
    rc = _load().gs_lcomb_tail(L, ptrs, dims, _u32p(fw), _u32p(xl), _stream(qe))
    _check(rc, "lcomb_tail")
    launch_counts["lcomb_tail"] += 1
    return out


# ----------------------------------------------------------- kernels 5, 6
_EW_OPS = {"mul": 0, "add": 1, "sub": 2}


def _coalesce(shape, strides_a, strides_b):
    """Drop unit dims and merge neighbours that are one run in both
    operands (a broadcast dim has stride 0 and merges with another)."""
    dims = [(n, sa, sb) for n, sa, sb in zip(shape, strides_a, strides_b) if n != 1]
    out = []
    for n, sa, sb in dims:
        if out and out[-1][1] == sa * n and out[-1][2] == sb * n:
            m, _, _ = out[-1]
            out[-1] = (m * n, sa, sb)
        else:
            out.append((n, sa, sb))
    return out or [(1, 0, 0)]


def field_ew(dev, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel 5 (csrc/field_ops.cu gs_field_ew): mul (Montgomery), add or
    sub mod p of int32 [L, ...] operands with the DeviceField's broadcast
    rule (batch axes right-aligned after the limb axis; a scalar [L, 1...]
    may stand on either side).  Any strides; the result is a new
    contiguous int32 [L, *broadcast shape]."""
    L = _field_l(dev)
    _require(a, "a", torch.int32, contiguous=False)
    _require(b, "b", torch.int32, contiguous=False)
    if a.shape[0] != L or b.shape[0] != L:
        raise ValueError(f"operands must have {L} limbs on axis 0: {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dim() < b.dim():
        a = a[(slice(None),) + (None,) * (b.dim() - a.dim())]
    elif b.dim() < a.dim():
        b = b[(slice(None),) + (None,) * (a.dim() - b.dim())]
    shape = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    out = torch.empty((L,) + shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    bstr = lambda t: [0 if t.shape[1 + i] == 1 else t.stride(1 + i) for i in range(len(shape))]
    dims = _coalesce(shape, bstr(a), bstr(b))
    if len(dims) > EW_MAX_DIMS:
        raise ValueError(f"field_ew takes at most {EW_MAX_DIMS} batch dims after coalescing, "
                         f"got shapes {tuple(a.shape)} and {tuple(b.shape)}")
    fw = np.ascontiguousarray(_field_words(dev))
    rc = _load().gs_field_ew(
        _EW_OPS[op], L, a.data_ptr(), _i64s([a.stride(0)] + [d[1] for d in dims]),
        b.data_ptr(), _i64s([b.stride(0)] + [d[2] for d in dims]), out.data_ptr(),
        len(dims), _i64s([d[0] for d in dims]), _u32p(fw), _stream(out))
    _check(rc, "field_ew")
    launch_counts["field_ew"] += 1
    return out


def outer_table(dev, outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """Kernel 6 (csrc/field_ops.cu gs_outer_table): [L, nj] x [L, s] ->
    [L, nj*s], t[j*s + k] = outer[j]*inner[k] (Montgomery)."""
    L = _field_l(dev)
    _require(outer, "outer", torch.int32, contiguous=False)
    _require(inner, "inner", torch.int32, contiguous=False)
    if outer.dim() != 2 or inner.dim() != 2 or outer.shape[0] != L or inner.shape[0] != L:
        raise ValueError(f"outer_table takes [L, nj] and [L, s], got {tuple(outer.shape)}, "
                         f"{tuple(inner.shape)}")
    outer, inner = outer.contiguous(), inner.contiguous()
    nj, s = outer.shape[1], inner.shape[1]
    out = torch.empty((L, nj * s), dtype=torch.int32, device=outer.device)
    if out.numel() == 0:
        return out
    fw = np.ascontiguousarray(_field_words(dev))
    rc = _load().gs_outer_table(L, outer.data_ptr(), nj, inner.data_ptr(), s,
                                out.data_ptr(), _u32p(fw), _stream(out))
    _check(rc, "outer_table")
    launch_counts["outer_table"] += 1
    return out


# Kernel A: binary-GCD steps a batch (csrc/field_ops.cu kGcdSteps).
GCD_STEPS = 30


def mont_inv_constant(p: int, L: int):
    """Kernel A's host constant: (T, the L/2 little-endian words of
    2^((32 - GCD_STEPS) T) R^3 mod p), T = ceil((2 len(p) - 1) / GCD_STEPS)
    the binary GCD's batches, R = 2^(16 L).  Each batch divides u and v by
    2^GCD_STEPS and its Montgomery word by 2^32, so the GCD ends with v =
    x^-1 2^((GCD_STEPS - 32) T); the last word product v c R^-1 turns that
    into x^-1 R^2, the Montgomery form of a^-1 for x = a R."""
    T = -(-(2 * p.bit_length() - 1) // GCD_STEPS)
    c = pow(2, (32 - GCD_STEPS) * T, p) * pow(1 << (16 * L), 3, p) % p
    return T, np.asarray([(c >> (32 * w)) & 0xFFFFFFFF for w in range(L // 2)], dtype=np.uint32)


def mont_inv(dev, a: torch.Tensor) -> torch.Tensor:
    """Kernel A (csrc/field_ops.cu gs_mont_inv): the contract of
    DeviceField.mont_pow_ref(a, p - 2).  a int32 [L, n] Montgomery (any
    layout; made contiguous) -> a new [L, n] tensor of a^-1 (0 for 0)."""
    L = _field_l(dev)
    _require(a, "a", torch.int32, contiguous=False)
    if a.dim() != 2 or a.shape[0] != L:
        raise ValueError(f"mont_inv takes a [{L}, n], got {tuple(a.shape)}")
    a = a.contiguous()
    out = torch.empty_like(a)
    if a.shape[1] == 0:
        return out
    batches, c = mont_inv_constant(dev.p, L)
    fw = np.ascontiguousarray(_field_words(dev))
    rc = _load().gs_mont_inv(L, a.data_ptr(), out.data_ptr(), a.shape[1], _u32p(c), batches,
                             _u32p(fw), _stream(a))
    _check(rc, "mont_inv")
    launch_counts["mont_inv"] += 1
    return out


# ----------------------------------------------------------------- kernel 8
def butterfly_max_n(L: int) -> int:
    """Largest local transform one block holds in shared memory: L x n
    limbs and the local root's L x n/2 twiddles."""
    n = 1
    while 12 * n * L <= SMEM_BYTES:       # 2n points: 8nL bytes of data, 4nL of twiddles
        n *= 2
    return n


def butterfly(dev, x: torch.Tensor, table: torch.Tensor, out: torch.Tensor = None,
              bitrev_in: bool = False) -> torch.Tensor:
    """Kernel 8 (csrc/butterfly.cu gs_butterfly): contract of
    ntt.radix2.butterfly_ref.  x [B, G, L, n] (any strides): B*G local
    n-point transforms, natural order in, or already bit-reversed with
    `bitrev_in`; table [L, n/2] the local root's powers (Montgomery); out
    [B, G, L, n] (any strides; x itself, or not overlapping x), or a new
    contiguous tensor."""
    L = _field_l(dev)
    _require(x, "x", torch.int32, contiguous=False)
    if x.dim() != 4 or x.shape[2] != L:
        raise ValueError(f"butterfly takes x [B, G, {L}, n], got {tuple(x.shape)}")
    B, G, _, n = x.shape
    if n < 2 or n & (n - 1) or n > butterfly_max_n(L):
        raise ValueError(f"local size {n} must be a power of two in [2, {butterfly_max_n(L)}]")
    _require(table, "table", torch.int32, (L, n // 2))
    if out is None:
        out = torch.empty((B, G, L, n), dtype=torch.int32, device=x.device)
    _require(out, "out", torch.int32, (B, G, L, n), contiguous=False)
    if B * G == 0:
        return out
    fw = np.ascontiguousarray(_field_words(dev))
    rc = _load().gs_butterfly(L, x.data_ptr(), _i64s(list(x.stride())), out.data_ptr(),
                              _i64s(list(out.stride())), table.data_ptr(), B, G,
                              n.bit_length() - 1, int(bitrev_in), _u32p(fw), _stream(x))
    _check(rc, "butterfly")
    launch_counts["butterfly"] += 1
    return out


# -------------------------------------------------------------- kernels 7, 9
def butterfly_stages(dev, x: torch.Tensor, table: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Kernels 7 and 9 (csrc/butterfly_stage.cu gs_butterfly_stages):
    contract of ntt.radix2.butterfly_stages_ref.  The k radix-2 DIT stages
    of half-size m, 2m, ..., 2^(k-1) m over x [B, L, n] (contiguous,
    16-byte aligned) in one launch, in place, m >= STAGE_MIN_M (a tile is
    16 columns wide); table [n/2, L] the powers of the n-th root
    (Montgomery), element-major.  Counted as `bfly_stage` (row 7) for
    m <= STAGE_SPLIT_ABOVE, else `bfly_stage_split` (row 9)."""
    L = _field_l(dev)
    _require(x, "x", torch.int32)
    if x.dim() != 3 or x.shape[1] != L:
        raise ValueError(f"butterfly_stages takes x [B, {L}, n], got {tuple(x.shape)}")
    B, _, n = x.shape
    if n & (n - 1) or m < STAGE_MIN_M or m & (m - 1) or k < 1 or m << k > n:
        raise ValueError(f"stages m={m} .. m*2^{k - 1} of an n={n} transform: powers of two, "
                         f"k >= 1, m >= {STAGE_MIN_M}, m * 2^k <= n")
    if B > 65535:
        raise ValueError(f"butterfly_stages takes at most 65535 rows, got {B}")
    if L * (STAGE_MIN_M << k) * 4 > SMEM_BYTES:
        raise ValueError(f"a {1 << k} x {STAGE_MIN_M} tile of {L} limbs exceeds shared memory")
    _require(table, "table", torch.int32, (n // 2, L))
    if x.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("butterfly_stages takes x and table 16-byte aligned")
    if B == 0:
        return x
    fw = np.ascontiguousarray(_field_words(dev))
    rc = _load().gs_butterfly_stages(L, x.data_ptr(), table.data_ptr(), B, n.bit_length() - 1,
                                     m.bit_length() - 1, k, _u32p(fw), _stream(x))
    _check(rc, "butterfly_stages")
    launch_counts["bfly_stage" if m <= STAGE_SPLIT_ABOVE else "bfly_stage_split"] += 1
    return x


# ------------------------------------------------------------- kernels 10, 11
def mont_chain(dev, x: torch.Tensor, depth: int) -> torch.Tensor:
    """Kernel 10 (csrc/probes.cu gs_mont_chain): contract of
    roofline.mont_chain_ref.  x int32 [L, n] contiguous -> x squared
    `depth` times by the word product; a new [L, n] tensor."""
    L = _field_l(dev)
    _require(x, "x", torch.int32)
    if x.dim() != 2 or x.shape[0] != L:
        raise ValueError(f"mont_chain takes x [{L}, n], got {tuple(x.shape)}")
    if depth < 0:
        raise ValueError("depth must be >= 0")
    out = torch.empty_like(x)
    fw = np.ascontiguousarray(_field_words(dev))
    rc = _load().gs_mont_chain(L, x.data_ptr(), out.data_ptr(), x.shape[1], depth, _u32p(fw),
                               _stream(x))
    _check(rc, "mont_chain")
    launch_counts["mont_chain"] += 1
    return out


def u32_chain(x: torch.Tensor, rounds: int = 1) -> torch.Tensor:
    """Kernel 11 (csrc/probes.cu gs_u32_chain): contract of
    roofline.u32_chain_ref.  x int32 (u32 bits, any shape, contiguous) ->
    a new tensor of the same shape; the chain runs `rounds` times."""
    _require(x, "x", torch.int32)
    if rounds < 1:
        raise ValueError(f"u32_chain takes rounds >= 1, got {rounds}")
    out = torch.empty_like(x)
    rc = _load().gs_u32_chain(x.data_ptr(), out.data_ptr(), x.numel(), rounds, _stream(x))
    _check(rc, "u32_chain")
    launch_counts["u32_chain"] += 1
    return out


# ----------------------------------------------------------------- kernel B
# csrc/queries.cu: query sets a launch, positions a set (its list in shared
# memory) and candidates a set.
SAMPLE_MAX_SETS = 32
SAMPLE_MAX_COUNT = 1024
SAMPLE_MAX_CAND = 1 << 24


def sample_window(max_count: int) -> int:
    """Kernel B's first window (a candidate a thread; later windows take
    all 256): the smallest of 64, 128, 256 that holds a quarter more
    candidates than the largest set takes, so a set is almost always
    complete in it, and fewer candidates an SM hash sooner."""
    return next(w for w in (64, 128, 256) if 4 * w >= 5 * max_count or w == 256)


def sample_queries(roots: torch.Tensor, specs) -> tuple:
    """Kernel B (csrc/queries.cu gs_sample_queries): contract of
    protocol.device_queries.sample_sets_ref.  roots int32 [S, 8]: each
    set's seed, a 32-byte digest as LE words; specs: S tuples (count, max_,
    exclude_multiples_of, n_cand), max_ a power of two <= 2^32, exclude 0
    or a power of two.  Returns (idx int64 [S, max count], zero-padded;
    found int32 [S])."""
    S = len(specs)
    _require(roots, "roots", torch.int32, (S, 8))
    if not 1 <= S <= SAMPLE_MAX_SETS:
        raise ValueError(f"sample_queries takes 1 to {SAMPLE_MAX_SETS} sets, got {S}")
    for count, max_, excl, n_cand in specs:
        if max_ < 1 or max_ & (max_ - 1) or max_ > 1 << 32:
            raise ValueError(f"max_ must be a power of two <= 2^32, got {max_}")
        if excl < 0 or excl & (excl - 1) or excl > 1 << 32:
            raise ValueError(f"exclude_multiples_of must be 0 or a power of two, got {excl}")
        if not 1 <= count <= SAMPLE_MAX_COUNT or not 1 <= n_cand <= SAMPLE_MAX_CAND:
            raise ValueError(f"count {count} and n_cand {n_cand} out of range")
    cap = max(c for c, _, _, _ in specs)
    idx = torch.empty((S, cap), dtype=torch.int64, device=roots.device)
    found = torch.empty((S,), dtype=torch.int32, device=roots.device)
    ints = lambda v: (ctypes.c_longlong * S)(*v)
    rc = _load().gs_sample_queries(
        roots.data_ptr(), S, ints([c for c, _, _, _ in specs]),
        ints([m - 1 for _, m, _, _ in specs]), ints([x for _, _, x, _ in specs]),
        ints([n for _, _, _, n in specs]), cap, sample_window(cap), idx.data_ptr(),
        found.data_ptr(), _stream(roots))
    _check(rc, "sample_queries")
    launch_counts["sample_queries"] += 1
    return idx, found
