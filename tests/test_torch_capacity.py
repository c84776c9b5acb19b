"""``config.CapacityBudget`` against the JAX package's capacity rules it
stands for in the port: ``Trainer._maybe_adapt_entry_cap`` and
``_grow_entry_cap_for_swap``; ``GsTrainer._maybe_adapt_gs_caps`` and its
``_grow_entry_cap_for_swap`` (entry and send budgets); and
``Viewer._adapt_entry_cap``.  Each is driven on a stub over one sequence
of observed demands, densify-swap growths and changes of the chunk."""

from types import SimpleNamespace

import pytest

from webdgs_tpu.parallel.gs_trainer import GsTrainer as JaxGsTrainer
from webdgs_tpu.render.viewer import Viewer as JaxViewer
from webdgs_tpu.train.trainer import Trainer as JaxTrainer
from webdgs_tpu_torch.config import CapacityBudget

# (kind, value, chunk): an observed demand, or a swap's (out, in) alive
# counts
EVENTS = [("obs", 100, 512), ("swap", (150, 100), 128), ("obs", 100, 128),
          ("obs", 300, 256), ("obs", 5_000, 128),
          ("obs", 5_200, 128), ("obs", 30_000, 128),
          ("swap", (150, 100), 128), ("obs", 4_000, 128),
          ("obs", 3_000, 128), ("obs", 2_900, 256),
          ("swap", (102, 100), 256), ("obs", 100, 256), ("obs", 50, 256),
          ("swap", (300, 100), 256), ("obs", 60_000, 128), ("obs", 0, 128),
          ("obs", 900, 128)] + [("obs", 700, 128)] * 12


def _trainer_stub(**fields):
    """The fields and constants the JAX trainers' capacity methods read;
    ``iteration`` 1 makes every observation an adaptation."""
    return SimpleNamespace(
        iteration=1, ENTRY_CAP_INTERVAL=JaxTrainer.ENTRY_CAP_INTERVAL,
        ENTRY_CAP_HEADROOM=JaxTrainer.ENTRY_CAP_HEADROOM,
        ENTRY_CAP_DECAY=JaxTrainer.ENTRY_CAP_DECAY, **fields)


# per case: the port's budgets, the reference stub, its observation of a
# demand, its swap growth (None: it never scales) and its capacities
CASES = {
    "trainer": (
        [dict(headroom=1.2, decay=0.9, shrink=2, floor=8)],
        lambda: _trainer_stub(_entry_cap_peak=0.0, _entry_cap_value=None),
        lambda s, x: JaxTrainer._maybe_adapt_entry_cap(
            s, {"tile_entries": x[0]}),
        JaxTrainer._grow_entry_cap_for_swap,
        lambda s: [s._entry_cap_value]),
    "gs_trainer": (
        [dict(headroom=1.2, decay=0.9, shrink=2, floor=8),
         dict(headroom=1.2, decay=0.9, shrink=2, floor=1)],
        lambda: _trainer_stub(_entry_cap_peak=0.0, _send_peak=0.0,
                              _gs_entry_cap=None, _gs_send_cap=None),
        lambda s, x: JaxGsTrainer._maybe_adapt_gs_caps(
            s, {"entries_local_max": x[0], "send_max": x[1]}),
        JaxGsTrainer._grow_entry_cap_for_swap,
        lambda s: [s._gs_entry_cap, s._gs_send_cap]),
    "viewer": (
        [dict(headroom=1.5, decay=0.0, shrink=3, floor=8)],
        lambda: SimpleNamespace(_entry_cap=None),
        lambda s, x: JaxViewer._adapt_entry_cap(s, x[0]),
        None,
        lambda s: [s._entry_cap]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_capacity_budget_matches_the_reference_rules(name):
    budget_kw, make_stub, observe, swap, capacities = CASES[name]
    budgets = [CapacityBudget(**kw) for kw in budget_kw]
    ref = make_stub()
    got, want = [], []
    for kind, value, chunk in EVENTS:
        ref.settings = SimpleNamespace(chunk=chunk)
        if kind == "obs":
            # the send load, a quarter of the entry load
            demands = [value, value // 4][:len(budgets)]
            observe(ref, demands)
            for budget, demand in zip(budgets, demands):
                budget.observe(demand, chunk)
        elif swap is not None:
            out_total, in_alive = value
            swap(ref, out_total, in_alive)
            for budget in budgets:
                budget.scale(out_total / in_alive, chunk)
        got.append([b.value for b in budgets])
        want.append(capacities(ref))
    assert got == want
    # the sequence grows and shrinks every capacity
    for seq in zip(*want):
        steps = list(zip(seq, seq[1:]))
        assert any(b > a for a, b in steps) and any(b < a for a, b in steps)
