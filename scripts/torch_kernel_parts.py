"""Where kernels A (`mont_inv`) and B (`sample_queries`) spend their device
time, on the card.

Kernel B, at the bench's six query sets: the kernel as built, and copies of
it compiled from csrc/queries.cu with the state's compression, the
candidates' compression, or both replaced by a few integer ops (the copies'
answers are wrong; only their times count), beside an empty kernel of the
same grid.  Kernel A, one P256 element: the kernel at T and 2T batches
(the slope is one batch's 30 steps and its update) through the library's
own entry.  Every time is torch.profiler's device time (chip_smoke.py
`device_ms`).

    python3 scripts/torch_kernel_parts.py        # on a machine with the card and nvcc

Prints one JSON line: the card's name and power limit, then ms per part.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

DIAG = r'''
#include "queries.cu"
namespace gs {
__global__ void empty_kernel(int32_t* out) { if (threadIdx.x == 4096) out[0] = 1; }
@KERNELS@
}  // namespace gs
extern "C" int parts(int which, const void* roots, int S, const long long* counts,
                     const long long* masks, const long long* excls, const long long* n_cands,
                     int cap, int first, void* idx, void* found, void* stream) {
  gs::SampleSpec spec = {};
  for (int s = 0; s < S; ++s) {
    spec.count[s] = static_cast<int>(counts[s]);
    spec.n_cand[s] = static_cast<int>(n_cands[s]);
    spec.mask[s] = static_cast<uint32_t>(masks[s]);
    spec.excl[s] = excls[s] != 0;
    spec.excl_mask[s] = static_cast<uint32_t>(excls[s] - 1);
  }
  auto st = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const uint32_t*>(roots);
  auto ix = static_cast<long long*>(idx);
  auto fo = static_cast<int32_t*>(found);
  switch (which) {
    case 0: gs::empty_kernel<<<S, gs::kSampleThreads, 0, st>>>(fo); break;
    case 1: gs::parts_kernel<false, true><<<S, gs::kSampleThreads, 0, st>>>(r, spec, cap, first,
                                                                           ix, fo); break;
    case 2: gs::parts_kernel<true, false><<<S, gs::kSampleThreads, 0, st>>>(r, spec, cap, first,
                                                                           ix, fo); break;
    case 3: gs::parts_kernel<false, false><<<S, gs::kSampleThreads, 0, st>>>(r, spec, cap, first,
                                                                            ix, fo); break;
  }
  return cudaGetLastError();
}
'''


def parts_source(csrc: str) -> str:
    """csrc/queries.cu's kernel as `parts_kernel<state, candidate>`:
    with `state` false the state is the root's words, with `candidate`
    false a candidate is (state + i) times a constant."""
    with open(os.path.join(csrc, "queries.cu")) as fh:
        src = fh.read()
    start = src.index("__global__ void __launch_bounds__(kSampleThreads)")
    end = src.index("}  // namespace gs", start)
    body = "template <bool kState, bool kCand>\n" + src[start:end]
    swaps = (("sample_queries_kernel(", "parts_kernel("),
             ("    sha256_block(m, d);\n",
              "    if (kState) sha256_block(m, d);\n"
              "    else for (int j = 0; j < 8; ++j) d[j] = m[j];\n"),
             ("c = candidate(st, static_cast<uint32_t>(i), mask);",
              "c = kCand ? candidate(st, static_cast<uint32_t>(i), mask)"
              " : ((st[7] + static_cast<uint32_t>(i)) * 2654435761u) & mask;"))
    for old, new in swaps:
        if body.count(old) != 1:
            raise RuntimeError(f"queries.cu changed: {old.strip()!r} not found once")
        body = body.replace(old, new)
    return DIAG.replace("@KERNELS@", body)


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke as cs
    from genstark_tpu_torch import kernels
    from genstark_tpu_torch.field import P256, create_prime_field
    if not torch.cuda.is_available():
        print("torch_kernel_parts: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    csrc = os.path.join(HERE, "genstark_tpu_torch", "csrc")
    lib_main = kernels._load()
    out = {"device": smi}

    # kernel B and its parts
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "parts.cu"), os.path.join(tmp, "parts.so")
        with open(cu, "w") as fh:
            fh.write(parts_source(csrc))
        subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", csrc, "-o", so, cu],
                       check=True)
        lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.parts.argtypes = [I, P, I, P, P, P, P, I, I, P, P, P]
    n_cand = lambda c: 32 * c + 512
    specs = [(48, 2 ** 17, 16, n_cand(48))] + [(24, 2 ** k, 16, n_cand(24))
                                                for k in (15, 13, 11, 9, 7)]
    S = len(specs)
    rng = np.random.default_rng(7)
    roots = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, size=(S, 8), dtype=np.int64)
                            .astype(np.int32), device="cuda")
    idx = torch.zeros((S, 48), dtype=torch.int64, device="cuda")
    found = torch.zeros(S, dtype=torch.int32, device="cuda")
    ints = lambda v: (ctypes.c_longlong * S)(*v)
    args = (ints([c for c, *_ in specs]), ints([m - 1 for _, m, *_ in specs]),
            ints([x for _, _, x, _ in specs]), ints([n for *_, n in specs]))

    def part(which):
        return lambda: lib.parts(which, roots.data_ptr(), S, *args, 48, kernels.sample_window(48),
                                 idx.data_ptr(), found.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    b = {"first window": kernels.sample_window(48),
         "kernel": cs.device_ms(lambda: kernels.sample_queries(roots, specs))}
    for which, label in ((0, "empty kernel"), (1, "no state compression"),
                         (2, "no candidate compression"), (3, "neither")):
        b[label] = cs.device_ms(part(which))
    out["sample_queries, the bench's six sets"] = b

    # kernel A at T and 2T batches
    dev = create_prime_field(P256).device_field("cuda")
    x = dev.from_numpy(cs.random_elements(rng, P256, 16, 1))
    y = torch.empty_like(x)
    T, c = kernels.mont_inv_constant(P256, 16)
    fw = np.ascontiguousarray(kernels._field_words(dev))

    def inv(batches):
        return lambda: lib_main.gs_mont_inv(16, x.data_ptr(), y.data_ptr(), 1, kernels._u32p(c),
                                            batches, kernels._u32p(fw), kernels._stream(x))
    a = {"batches": T, "kernel": cs.device_ms(inv(T)), "2T batches": cs.device_ms(inv(2 * T))}
    a["a batch"] = (a["2T batches"] - a["kernel"]) / T
    out["mont_inv, one P256 element"] = a
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
