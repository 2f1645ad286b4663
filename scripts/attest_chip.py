"""chip_smoke.py's attestation phases alone, in a fresh process on one
NVIDIA GPU: build both kernels, hold them to their plain versions at every
state count the phases launch, then the depth-1 phases ([attest-golden],
[check-golden], [attest-small], [attest-many]) and the composed ones
([compose-small], [attest-attestation], [compose-golden],
[check-composed-golden]) with their measurements.  The same code as in
chip_smoke.py, without the earlier phases' live objects and device
allocations beside it.

    python3 scripts/attest_chip.py [--phases all|depth1|composed]
                                   [--report PATH]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from plonky25_torch.ops import build  # noqa: E402
from plonky25_torch.proof import FriConfig, derive_config, load_proof  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="write the measurements here as JSON")
    ap.add_argument("--phases", default="all",
                    choices=("all", "depth1", "composed"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attest_chip: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    report = {"card": cs.nvidia_smi("name,power.limit"), "phase_seconds": {}}
    print(report["card"])
    build.build_many(["poseidon2", "poseidon2_soa"])
    proof = load_proof(os.path.join(cs.FIXTURES, "proof_fibonacci_refimpl.json"))
    fc = FriConfig(1, 100, 16)
    att = cs.attestation_inputs(proof, fc)
    aos = sorted(att["aos_sizes"])
    soa = sorted(set().union(*(a[cs.SOA] for a in att["prove_shapes"])))
    err = max([cs.aos_vs_plain(cs.random_states(n, n)) for n in aos]
              + [cs.soa_vs_plain_and_aos(cs.random_states(n, n, True))
                 for n in soa])
    cs.check(err == 0, f"a kernel differs from its plain version by {err}")
    print(f"[kernel] both kernels, each variant, bit-equal to their plain "
          f"versions at the attestation paths' N={','.join(map(str, aos))} "
          f"(state-major) and N={','.join(map(str, soa))} (lane-major)")
    lap_t = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        report["phase_seconds"][phase] = now - lap_t[0]
        lap_t[0] = now

    if args.phases in ("all", "depth1"):
        cs.attestation_phases(att, proof, fc, derive_config(proof, fc),
                              {}, {}, report, lap)
    if args.phases in ("all", "composed"):
        cs.composed_phases(att, proof, fc, {}, {}, report, lap)
    report["seconds"] = time.perf_counter() - t_start
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"phase_seconds": report["phase_seconds"],
                      "seconds": report["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
