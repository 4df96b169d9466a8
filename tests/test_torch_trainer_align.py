"""``Trainer.run`` starts each step together on every rank of the mesh,
and runs the step without Python's cyclic collector.

One spawn of 4 gloo ranks (file rendezvous) trains the reduced float32
smollm-360m for 2 steps on a 2 × 2 ``("data", "model")`` mesh, each rank
reaching ``run`` 0.4 s after the one before it.  The step function is
wrapped to read the host's monotonic clock (shared by the ranks) and
``gc.isenabled()`` as each step begins.  Checks: every step begins on
all ranks within 0.2 s of each other although the ranks arrived 1.2 s
apart (the barrier on the data group, then the model group, chains into
one over the mesh); the collector is off inside every step and back on
after ``run``; the losses are finite and the same on every rank.  About
25 s alone on the CPU.
"""
import gc
import math
import time

import pytest

from repro_torch.core import dist
from repro_torch.launch.train import build_trainer, parser

WORLD = 4
STAGGER_S = 0.4
STEPS = 2


def _rank(rank, world):
    args = parser().parse_args(
        ["--arch", "smollm-360m", "--mesh", "2x2", "--steps", str(STEPS),
         "--batch", "4", "--seq", "16", "--device", "cpu", "--dtype",
         "float32", "--log-every", "1"])
    trainer = build_trainer(args, verbose=False)
    module, opt_state = trainer.init_state(args.seed)
    inner, seen = trainer.step_fn, []

    def step_fn(*a):
        seen.append((time.perf_counter(), gc.isenabled()))
        return inner(*a)

    trainer.step_fn = step_fn
    time.sleep(STAGGER_S * rank)
    _, _, hist = trainer.run(STEPS, module, opt_state)
    return {"starts": [t for t, _ in seen], "gc_in_step": [g for _, g in seen],
            "gc_after": gc.isenabled(), "losses": [h["loss"] for h in hist]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return dist.run_ranks(_rank, WORLD,
                          rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                          threads=1, timeout_s=300)


def test_steps_begin_together(ranks):
    for s in range(STEPS):
        starts = [r["starts"][s] for r in ranks]
        assert max(starts) - min(starts) < 0.2, (s, starts)
    losses = [r["losses"] for r in ranks]
    assert all(math.isfinite(x) for x in losses[0])
    assert all(x == losses[0] for x in losses), losses


def test_no_collector_inside_a_step(ranks):
    for r in ranks:
        assert r["gc_in_step"] == [False] * STEPS
        assert r["gc_after"]
