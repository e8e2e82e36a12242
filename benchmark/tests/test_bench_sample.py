"""The sample of the window's units that the reference checks: the first
unit always, a bounded sample of each stratum drawn from the seed, kept in
buffers made before the window."""

import torch

from benchmark.harness import manifest
from benchmark.harness.base import Sample, scenario_of


def offer_all(sample, n, stratum=lambda i: "tick"):
    for i in range(n):
        sample.offer({"k": i, "x": torch.full((2,), float(i))}, stratum(i))


def test_first_unit_and_sizes():
    s = Sample({"tick": 5, "mpc": 2}, seed=2**33 + 1)
    offer_all(s, 400, lambda i: "mpc" if i % 40 == 0 else "tick")
    units = s.units()
    assert units[0]["index"] == 0 and units[0]["k"] == 0
    assert s.n == 400
    mpc = [u for u in units[1:] if u["k"] % 40 == 0]
    assert len(mpc) == 2 and len(units) == 1 + 5 + 2
    # Each kept unit holds its own values, copied when it was kept.
    for u in units:
        assert torch.equal(u["x"], torch.full((2,), float(u["k"])))


def test_same_seed_same_sample_and_spread_over_the_window():
    picks = []
    for seed in (7, 7, 8):
        s = Sample({"tick": 16}, seed)
        offer_all(s, 1000)
        picks.append([u["index"] for u in s.units()])
    assert picks[0] == picks[1] and picks[0] != picks[2]
    # A uniform sample of 1000 units: some kept units lie in the window's
    # last half, where a sample of the first units only would have none.
    assert max(picks[0]) > 500


def test_buffers_made_before_the_window_are_reused():
    s = Sample({"tick": 3, "kick": 1}, seed=3)
    offer_all(s, 2)  # the warm-up
    s.fill()
    buffers = {id(u["x"]) for kept in s.slots.values() for u in kept if u is not None}
    assert len(buffers) == 1 + 3 + 1  # every stratum's slots, like the first unit
    s.reset()
    offer_all(s, 200, lambda i: "kick" if i % 50 == 7 else "tick")
    kept = {id(u["x"]) for u in s.units()}
    assert kept <= buffers


def test_scenario_fields_set_both_sides():
    cell = manifest.resolve("serving_b1")
    from benchmark.reference.g1ref.engine import tick as eng_r
    from g1_locomotion_tpu_torch.engine import tick as eng

    for module in (eng, eng_r):
        p = scenario_of(module, cell.config, "cpu", torch.float32)
        assert float(p.gait.n_steps) == 0.0
