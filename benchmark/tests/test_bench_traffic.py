"""The traffic generator: the same seed gives the same inputs, another seed
others, and the drawn values lie in the mix's ranges."""

import torch

from benchmark.harness import manifest, scenario as sc

ROOT = manifest.ROOT


def draws(mix, seed, batch=64):
    traffic = manifest.read_json(ROOT / "benchmark" / "traffic" / f"{mix}.json")
    gen = sc.generator(seed, "cpu")
    d = sc.draw_instances(traffic, gen, batch, torch.float32)
    episodes = [sc.episode_draw(traffic, key, gen, batch, torch.float32)
                for key in ("init_lateral_velocity", "kick")]
    return traffic, d, episodes


def flat(d, episodes):
    parts = list(d.values.values()) + [e for e in episodes if e is not None]
    return torch.cat(parts)


def test_deterministic_and_seed_dependent():
    big = 2**31 + 977  # seeds past 32 signed bits
    for mix in ("sweepspec_draws", "sweepspec_kick60", "standing_lateral_v0"):
        _, d1, e1 = draws(mix, big)
        _, d2, e2 = draws(mix, big)
        _, d3, e3 = draws(mix, big + 1)
        assert torch.equal(flat(d1, e1), flat(d2, e2))
        assert not torch.equal(flat(d1, e1), flat(d3, e3))


def test_ranges_and_application():
    traffic, d, episodes = draws("sweepspec_draws", 5)
    for spec in traffic["draws"]:
        x = d.values[spec["name"]]
        assert float(x.min()) >= spec["range"][0] and float(x.max()) <= spec["range"][1]
    from benchmark.reference.g1ref.engine import tick as eng

    base = eng.default_scenario(device="cpu", dtype=torch.float32)
    p = sc.apply_draws(base, traffic, d)
    assert p.v_cmd.shape == (64, 2)
    assert torch.equal(p.v_cmd[:, 0], d.values["v_cmd_x"])
    assert torch.allclose(p.srbd.mass, base.srbd.mass * d.values["mass_scale"])
    assert p.srbd.inertia.shape == (64, 3, 3)
    assert torch.equal(p.wbid_gains.mu, d.values["friction"])
    assert p.batch() == 64
    _, _, (_, kick) = draws("sweepspec_kick60", 5)
    assert float(kick.min()) >= 0.0 and float(kick.max()) <= 0.15


def test_episode_draws_do_not_depend_on_batch_draw_count():
    """Episode draws follow the parameter draws in one fixed order."""
    _, _, e1 = draws("standing_lateral_v0", 11, batch=1)
    _, _, e2 = draws("standing_lateral_v0", 11, batch=1)
    assert torch.equal(e1[0], e2[0]) and e1[1] is None
