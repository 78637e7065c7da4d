"""The few-step loss trajectory against the reference's golden log.

The reference's acceptance run (`run_train.sh` on the 10-record sample,
/root/reference/README.md:116-122) logs training steps 2 and 4. The
step-2 init CE is analytic (label base rates at sigmoid init), so it is
held to a tight band; the step-4 values are held to the decrease SHAPE.
Data ordering and init RNG differ from the reference's run, so these are
band checks, not bit-equality. Used by `scripts/fidelity_check.py` and
`chip_smoke.py`.
"""

import logging
import re

# Reference golden log, README.md:116-122 (run_train.sh on the 10-record
# sample): the two logged steps of the acceptance run.
GOLDEN = {
    2: {"teacher": 1914.09, "l_rep": 1.16, "l_pred": 0.01, "l_ce": 1914.1},
    4: {"teacher": 1908.12, "l_rep": 1.52, "l_pred": 0.01, "l_ce": 1913.41},
}

_STEP_RE = re.compile(
    r"training step (\d+)\|.*Teacher_Loss: ([\d.]+)\| "
    r"L_REP: ([\d.]+)\| L_PRED: ([\d.]+)\| L_CE: ([\d.]+)"
)


class StepCapture(logging.Handler):
    """Collects the trainer's per-step metric lines."""

    def __init__(self):
        super().__init__()
        self.steps = {}

    def emit(self, record):
        m = _STEP_RE.search(record.getMessage())
        if m:
            self.steps[int(m.group(1))] = {
                "teacher": float(m.group(2)),
                "l_rep": float(m.group(3)),
                "l_pred": float(m.group(4)),
                "l_ce": float(m.group(5)),
            }


def check_trajectory(steps) -> bool:
    """Band checks of the loss-decrease SHAPE vs the golden log."""
    ok = True

    def expect(cond, msg):
        nonlocal ok
        status = "ok" if cond else "FAIL"
        print(f"  [{status}] {msg}")
        ok = ok and cond

    s2, s4 = steps.get(2), steps.get(4)
    expect(s2 is not None and s4 is not None,
           f"steps 2 and 4 logged (got {sorted(steps)})")
    if not (s2 and s4):
        return False
    print(f"  step 2: {s2}  (golden {GOLDEN[2]})")
    print(f"  step 4: {s4}  (golden {GOLDEN[4]})")
    # step-2 init CE is analytic (label base rates at sigmoid init):
    # tight band around the golden 1914.09
    expect(abs(s2["teacher"] - GOLDEN[2]["teacher"]) < 2.0,
           f"step-2 Teacher_Loss {s2['teacher']:.2f} within 2.0 of "
           f"{GOLDEN[2]['teacher']}")
    expect(abs(s2["l_ce"] - GOLDEN[2]["l_ce"]) < 2.0,
           f"step-2 L_CE {s2['l_ce']:.2f} within 2.0 of {GOLDEN[2]['l_ce']}")
    # step-4 shape: teacher CE falls (golden: -5.97), student CE falls
    # less (golden: -0.69), L_REP grows as the towers specialize
    # (golden: 1.16 -> 1.52), L_PRED stays near zero (golden: 0.01)
    drop = s2["teacher"] - s4["teacher"]
    expect(1.0 < drop < 20.0,
           f"step-4 teacher CE decrease {drop:.2f} in (1, 20) "
           f"(golden {GOLDEN[2]['teacher'] - GOLDEN[4]['teacher']:.2f})")
    expect(s4["l_ce"] < s2["l_ce"],
           f"step-4 L_CE {s4['l_ce']:.2f} < step-2 {s2['l_ce']:.2f}")
    # L_REP's init LEVEL tracks the data distribution (golden 1.16 on
    # real YT8M features; ~0.08 on this synthetic sample) — only the
    # smallness and the growth shape below are data-independent
    expect(0.0 < s2["l_rep"] < 3.0,
           f"step-2 L_REP {s2['l_rep']:.2f} small at init, in (0, 3) "
           f"(golden {GOLDEN[2]['l_rep']} on real features)")
    expect(s4["l_rep"] > s2["l_rep"],
           f"L_REP grows {s2['l_rep']:.2f} -> {s4['l_rep']:.2f} "
           f"(golden {GOLDEN[2]['l_rep']} -> {GOLDEN[4]['l_rep']})")
    expect(s2["l_pred"] < 0.2 and s4["l_pred"] < 0.2,
           f"L_PRED stays near zero ({s2['l_pred']}, {s4['l_pred']}; "
           f"golden 0.01)")
    return ok
