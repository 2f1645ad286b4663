"""What torch.profiler costs on one NVIDIA GPU, tracing CUDA activity alone
against CPU and CUDA activity, on check_attestation of the golden bundle
(artifacts/attestation_fibonacci.json against the fib(64) fixture proof,
about 320k kernels): the wall seconds of the profiled run and of
key_averages, the device ms and the kernel count each sees.

    python3 scripts/profiler_cost.py
"""

import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import plonky25_torch.attest as A  # noqa: E402
from plonky25_torch.models import FibonacciAir  # noqa: E402
from plonky25_torch.ops import build  # noqa: E402
from plonky25_torch.proof import FriConfig, load_proof  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("profiler_cost: no CUDA device", file=sys.stderr)
        return 2
    build.build_many(["poseidon2", "poseidon2_soa"])
    proof = load_proof(os.path.join(ROOT, "tests", "fixtures",
                                    "proof_fibonacci_refimpl.json"))
    golden = A.load_bundle(os.path.join(ROOT, "artifacts",
                                        "attestation_fibonacci.json"))

    def fn():
        return A.check_attestation(golden, proof, FibonacciAir(),
                                   FriConfig(1, 100, 16))

    assert fn()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"unprofiled wall ms {(time.perf_counter() - t0) * 1e3:.1f}")
    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts, acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ms = kernels = 0
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", 0) or 0
            if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
                ms += t / 1e3
                kernels += ev.count
        print(f"{[a.name for a in acts]}: profiled run {t1 - t0:.1f} s, "
              f"key_averages {time.perf_counter() - t1:.1f} s, device "
              f"{ms:.1f} ms in {kernels} kernels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
