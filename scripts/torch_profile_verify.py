"""Profile the port's `Stark.verify` on a real proof: prove MiMC-128 once (the
bench's AIR and options, secret input 3), then time and cProfile repeated
verifications.  The port of scripts/profile_verify.py; the verifier is
host-only, so only the prove runs on the card.

    python scripts/torch_profile_verify.py [log2_steps] [--profile] [--device DEV]

log2_steps defaults to 17; DEV to cuda (pass cpu to prove with the plain
versions on the CPU).  Prints the prove's seconds and the best of 7
verifications in ms; with --profile, the 25 costliest calls (cumulative) of
5 more.  Imports only genstark_tpu_torch and numpy / torch.
"""
from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv and argv[0].isdigit() else 17
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    steps = 1 << n
    from examples.mimc_torch import make_mimc_stark, run_mimc
    from genstark_tpu_torch.protocol import Assertion

    stark, constants = make_mimc_stark(steps, device)
    controls = run_mimc(stark.air.field, steps, constants, 3)
    assertions = [Assertion(0, 0, controls[0]), Assertion(steps - 1, 0, controls[-1])]
    t0 = time.monotonic()
    proof = stark.prove(assertions, [[3]])
    print(f"prove {time.monotonic() - t0:.1f}s on {device}", flush=True)
    parsed = stark.parse(stark.serialize(proof))

    # warm + time
    best = float("inf")
    for _ in range(7):
        t0 = time.monotonic()
        assert stark.verify(assertions, parsed)
        best = min(best, time.monotonic() - t0)
    print(f"verify best {best * 1000:.1f} ms at 2^{n}", flush=True)

    if "--profile" in argv:
        pr = cProfile.Profile()
        pr.enable()
        for _ in range(5):
            stark.verify(assertions, parsed)
        pr.disable()
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(25)
        print(s.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
