"""The controls of the benchmark's correctness check, at a cell's own size:

    python3 p3bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it runs the cell's set-up once, then the cell's traced
number of calls with the program (its readings; left out with
--no-program) and with each control in the program's place, each judged
as a run is, and prints every side's compared numbers.  A control breaks one guarantee the configuration
states, so the check has to find it not correct:

  * a verify cell: the plain reference with its Merkle-path checks left
    out (a verifier that trusts every opening) gives the verdicts; and the
    plain reference with its constraint check left out (a verifier that
    accepts a proof of a trace that breaks the AIR);
  * a prove cell: the program proves at 8 proof-of-work bits fewer than
    the configuration states (16 -> 8: the grind 256 times cheaper).

The benchmark's own runs never run a control."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from p3bench.harness.core import CACHES, ROOT, Cell  # noqa: E402

POW_BITS_DROPPED = 8


def _answer_with(op, verdicts):
    """The reference's verdicts answer in the program's place."""
    lanes = {id(ws): lanes for ws, lanes in zip(op.batches, op.lanes)}
    op.verify = lambda ws, on_stage: verdicts[lanes[id(ws)]]


def verify_control(op):
    """The reference without Merkle checks answers."""
    _answer_with(op, op.reference_verdicts(check_merkle=False))


def constraint_control(op):
    """The reference without the constraint check answers."""
    _answer_with(op, op.reference_verdicts(check_constraints=False))


def prove_control(op):
    """The program at fewer proof-of-work bits than the configuration's."""
    from plonky25_torch.proof import FriConfig
    from plonky25_torch.prover.prove import TorchProver

    op.prover.release_programs()        # the weak prover's memory
    bits = op.config["fri"]["proof_of_work_bits"]
    fc = FriConfig(**dict(op.config["fri"],
                          proof_of_work_bits=max(0, bits - POW_BITS_DROPPED)))
    weak = TorchProver(op.air, op.config["log_n"], fc, op.device,
                       op.prover.quotient_eval_chunks)
    op.prove = lambda cols, on_stage: weak.prove_columns(cols,
                                                         fused=False)[0]


CONTROLS = {"verify_batch": {"merkle": verify_control,
                             "constraints": constraint_control},
            "prove_single": {"pow": prove_control}}


def sides(cell, seed, device="cuda", program=True):
    """{side: the op's judgement} of the program and each control, from
    one set-up of the cell."""
    op = cell.op(seed, device)
    op.setup()
    hooks = dict(CONTROLS[cell.traffic["op"]])
    if program:
        hooks = {"program": None, **hooks}
    out = {}
    for side, hook in hooks.items():
        op.outputs = []
        for attr in ("verify", "prove"):       # the program's own again
            op.__dict__.pop(attr, None)
        if hook is not None:
            hook(op)
        for i in range(cell.cell["trace_calls"]):
            op.call(i)
        out[side] = op.check()
    op.release()
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-program", action="store_true",
                    help="run the controls only (the benchmark's own runs "
                         "give the program's readings)")
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = os.path.join(ROOT, rel)
    cell = Cell.load(args.workload)
    for seed in args.seeds:
        for side, r in sides(cell, seed,
                             program=not args.no_program).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "correct": r["correct"],
                              "checks": {k: {"value": v, "limit": lim}
                                         for k, (v, lim)
                                         in r["checks"].items()}}),
                  flush=True)


if __name__ == "__main__":
    main()
