"""Rules of the PyTorch port: it imports neither JAX nor plonky25_tpu, its
entry points never run on the CPU unless asked to, and chip_smoke.py
refuses to run without a GPU or without the repository."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "plonky25_torch")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "proof_fibonacci_refimpl.json")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_jax_or_reference_package_in_sys_modules():
    code = (
        "import sys, pkgutil, importlib\n"
        "import plonky25_torch\n"
        "for m in pkgutil.walk_packages(plonky25_torch.__path__, "
        "'plonky25_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'plonky25_tpu')))\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules "
        "if m.startswith('plonky25_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("clean")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_sources_import_no_jax_and_read_no_environment(path):
    with open(path) as f:
        src = f.read()
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "plonky25_tpu"), n
    assert "os.environ" not in src and "getenv" not in src


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    from plonky25_torch import FriConfig, derive_config, load_proof
    from plonky25_torch import get_verifier, verify_proof
    from plonky25_torch.convert import from_jax
    from plonky25_torch.models import FibonacciAir
    from plonky25_torch.ops import poseidon2
    from plonky25_torch.models.fibonacci import fibonacci_trace
    from plonky25_torch.parallel import (BatchVerifier,
                                         MultiHostBatchVerifier,
                                         ShardedVerifier, make_batch_mesh,
                                         make_host_mesh, make_mesh,
                                         verify_proof_batch_multihost,
                                         verify_proof_sharded)
    from plonky25_torch.prover import (BatchProver, TorchProver, prove,
                                       prove_batch_on_device, prove_on_device)
    from plonky25_torch.witness import pack_witness
    import plonky25_torch.attest as A
    import plonky25_torch.attest_program as ap

    def no_cpu_work(state):
        raise AssertionError("ran on the CPU without being asked")

    monkeypatch.setattr(poseidon2, "poseidon2_permute_plain", no_cpu_work)
    monkeypatch.setattr(poseidon2, "poseidon2_permute_soa_plain", no_cpu_work)
    proof = load_proof(FIXTURE)
    fc = FriConfig(1, 100, 16)
    cfg = derive_config(proof, fc)
    bundle = A.load_bundle(os.path.join(ROOT, "artifacts",
                                        "attestation_fibonacci.json"))
    rows = ap.build_verification_schedule(proof, cfg, FibonacciAir(),
                                          bundle.samples)
    composed = A.ComposedAttestation(
        outer=bundle, inner_stark=bundle.stark, inner_gamma=bundle.gamma,
        inner_acc=bundle.acc, inner_samples=bundle.samples,
        inner_n_rows=bundle.n_rows, target_shape=A._target_shape_of(cfg))
    for call in (lambda: verify_proof(proof, FibonacciAir(), fc),
                 lambda: get_verifier(FibonacciAir(), cfg),
                 lambda: BatchVerifier(FibonacciAir(), cfg),
                 lambda: pack_witness(proof, cfg),
                 lambda: from_jax({}),
                 lambda: prove(FibonacciAir(), fibonacci_trace(16), fc),
                 lambda: TorchProver(FibonacciAir(), 4, fc),
                 lambda: BatchProver(FibonacciAir(), 4, fc),
                 lambda: prove_batch_on_device(
                     FibonacciAir(), [fibonacci_trace(16)] * 2, fc),
                 lambda: A.attest(proof, FibonacciAir(), fc),
                 lambda: A.attest_many([proof] * 2, FibonacciAir(), fc),
                 lambda: A.check_attestation(bundle, proof, FibonacciAir(), fc),
                 lambda: A.check_attestations(bundle, [proof], FibonacciAir(),
                                              fc),
                 lambda: A.attest_composed(proof, FibonacciAir(), fc,
                                           inner=bundle),
                 lambda: A.check_composed(composed, FibonacciAir(), fc),
                 lambda: A.attest_attestation(bundle),
                 lambda: A.check_attested_attestation(
                     bundle, bundle, proof, FibonacciAir(), fc),
                 lambda: prove_on_device(FibonacciAir(), fibonacci_trace(16),
                                         fc),
                 lambda: ap.derive_gammas(rows),
                 lambda: ap.build_trace_cols(rows, bundle.gamma),
                 # the multi-device entry points refuse before they look
                 # for a process group (none exists here)
                 lambda: make_mesh(),
                 lambda: make_batch_mesh(1, 1),
                 lambda: make_host_mesh(),
                 lambda: ShardedVerifier(FibonacciAir(), cfg),
                 lambda: verify_proof_sharded(proof, FibonacciAir(), fc),
                 lambda: MultiHostBatchVerifier(FibonacciAir(), cfg),
                 lambda: verify_proof_batch_multihost([proof] * 2,
                                                      FibonacciAir(), fc),
                 lambda: TorchProver(FibonacciAir(), 4, fc,
                                     lde_mesh=object())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
