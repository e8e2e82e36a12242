"""What every driver shares: the run's generator, episodes, and the sample
of the window's units that the reference checks."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import scenario as sc


def _copy_into(buf, value):
    """``value`` with every tensor copied into ``buf``'s (made like it where
    ``buf`` is None); anything else is kept as it is."""
    if isinstance(value, torch.Tensor):
        if buf is None:
            return value.detach().clone()
        return buf.copy_(value)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        bufs = (None,) * len(value) if buf is None else buf
        return type(value)(*(_copy_into(b, v) for b, v in zip(bufs, value)))
    if isinstance(value, dict):
        bufs = {} if buf is None else buf
        return {k: _copy_into(bufs.get(k), v) for k, v in value.items()}
    return value


class Sample:
    """The units the reference checks, drawn while the window runs: the
    window's first unit, and of each stratum a uniform sample of
    ``sizes[stratum]`` units (reservoir sampling from the seed). A kept
    unit's tensors are copied into buffers that live from the first unit of
    their size to the end of the run, so keeping the sample takes no new
    device memory once set-up has run, and no other unit is held."""

    def __init__(self, sizes: Dict[str, int], seed: int):
        self.sizes, self.seed = {k: int(v) for k, v in sizes.items()}, int(seed)
        self.slots: Dict[str, List[Optional[dict]]] = {}  # buffers, by stratum
        self.reset()

    def reset(self) -> None:
        """Forget the units offered so far; the buffers stay."""
        self.rng = np.random.default_rng(self.seed % (2**63))
        self.n = 0
        self.seen: Dict[str, int] = {}
        self.kept: Dict[str, List[Optional[dict]]] = {}

    def offer(self, unit: dict, stratum: str) -> None:
        index, self.n = self.n, self.n + 1
        if index == 0:
            stratum, size = "first", 1
        else:
            size = self.sizes.get(stratum, 0)
        seen = self.seen.get(stratum, 0)
        self.seen[stratum] = seen + 1
        j = seen if seen < size else int(self.rng.integers(0, seen + 1))
        if j >= size:
            return
        slots = self.slots.setdefault(stratum, [None] * size)
        kept = self.kept.setdefault(stratum, [None] * size)
        slots[j] = _copy_into(slots[j], dict(unit, index=index))
        kept[j] = slots[j]

    def fill(self) -> None:
        """Make every stratum's buffers now, like a unit already kept of that
        stratum (or the first unit), so that the window makes none."""
        first = (self.slots.get("first") or [None])[0]
        for stratum, size in self.sizes.items():
            slots = self.slots.setdefault(stratum, [None] * size)
            like = next((u for u in slots if u is not None), first)
            if like is None:
                continue
            for j, u in enumerate(slots):
                if u is None:
                    slots[j] = _copy_into(None, like)

    def units(self) -> List[dict]:
        """The kept units, in window order."""
        out = [u for kept in self.kept.values() for u in kept if u is not None]
        return sorted(out, key=lambda u: u["index"])


class Driver:
    """A cell's system under test (``side`` "program") or the control
    (``side`` "control": the plain reference at the configuration's dtype
    with TF32 on, put in the program's place).

    A unit of the window is one call into the system (a tick or a
    period). Subclasses set ``ticks_per_unit`` and implement ``_build``,
    ``_warm_up``, ``_start_episode``, ``_step`` and ``check``."""

    ticks_per_unit = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device, side: str = "program"):
        if side not in ("program", "control"):
            raise ValueError(f"benchmark: side must be program or control, not {side!r}")
        self.config, self.traffic, self.seed, self.side = config, traffic, int(seed), side
        self.device = torch.device(device)
        self.dtype = sc.DTYPES[config["dtype"]]
        self.batch = int(config["batch"])
        self.gen = sc.generator(seed, self.device)
        self.draws = sc.draw_instances(traffic, self.gen, self.batch, self.dtype)
        self.episode_units = int(traffic["episode_units"])
        # A unit of the window (a tick or a period) is a dict: its episode,
        # its index in the episode, what the driver keeps of its inputs and
        # outputs. The sample keeps the few that the reference checks.
        self.sample = Sample(config["check_units"], seed)
        self.episodes: List[Dict[str, torch.Tensor]] = []
        self.episode = -1
        self.k = 0

    # -- the run --------------------------------------------------------
    def setup(self, warm: bool = True) -> None:
        """Build the system, warm up every shape the traffic uses (unless
        ``warm`` is False: a process that ran the same shapes before), and
        stand at the start of the first episode."""
        self._build()
        self._new_episode()
        if warm:
            self._warm_up()
            self.sample.fill()
        self._start_episode(self.episodes[0])
        self.sample.reset()
        self.k = 0

    def step(self) -> None:
        """One unit of the window: a new episode where the last one ended."""
        if self.k == self.episode_units:
            self._new_episode()
            self._start_episode(self.episodes[-1])
            self.k = 0
        unit = {"episode": self.episode, "k": self.k}
        self._step(unit)
        self.sample.offer(unit, self._stratum(unit))
        self.k += 1

    def _stratum(self, unit: dict) -> str:
        """The stratum of the sample a unit belongs to."""
        return "unit"

    def _new_episode(self) -> None:
        self.episode += 1
        self.episodes.append({key: sc.episode_draw(self.traffic, key, self.gen, self.batch,
                                                   self.dtype)
                              for key in ("init_lateral_velocity", "kick")})

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- what the readers see -------------------------------------------
    @property
    def count(self) -> int:
        """Units run since set-up."""
        return self.sample.n

    def window_record(self) -> Dict[str, float]:
        return {"batch": self.batch, "ticks_per_unit": self.ticks_per_unit}

    def program_record(self) -> Dict[str, object]:
        """The program's own spans since set-up or the last call."""
        return {}

    def release(self) -> None:
        """Free the system's objects; the records stay."""

    # -- the check ------------------------------------------------------
    def check(self, reference_device):
        """The gaps (``compare.Gaps``) of the sampled units
        (``self.sample.units()``: the window's first, which starts from the
        episode's start, so the reference follows it from its own start, and
        a sample of each stratum) against the plain reference at float64 on
        ``reference_device``."""
        raise NotImplementedError


def to_tuple(cls, values, device, dtype=torch.float64):
    """A reference NamedTuple of class ``cls`` from another side's tuple
    with the same fields (each tensor copied, in dtype on device)."""
    if tuple(cls._fields) != tuple(values._fields):
        raise TypeError(f"benchmark: {type(values).__name__} fields {values._fields} are not "
                        f"{cls.__name__}'s {cls._fields}")
    return cls(*(v.detach().to(device=device, dtype=dtype) for v in values))


def engine_config(eng, config: dict):
    """A side's ``EngineConfig`` with the configuration's ``engine`` fields."""
    return sc.apply_overrides(eng.EngineConfig(), config.get("engine", {}))


def scenario_of(eng, config: dict, device, dtype):
    """The configuration's base scenario (``config['scenario']``, a function
    of ``engine/tick``) from a side's module, every leaf shared, with the
    configuration's ``scenario_fields`` (dotted path: number) set."""
    params = getattr(eng, config["scenario"])(device=device, dtype=dtype)
    return sc.apply_overrides(params, {
        path: torch.tensor(float(value), dtype=dtype, device=device)
        for path, value in config.get("scenario_fields", {}).items()})


def flat_state(state) -> torch.Tensor:
    """(B, k): every field of a carried state, one row per instance."""
    B = state[0].shape[0]
    return torch.cat([f.reshape(B, -1).to(torch.float64) for f in state], dim=1)


def ref_modules():
    """The plain reference's modules (a frozen copy of the port's plain
    path: benchmark/reference/g1ref)."""
    from benchmark.reference.g1ref.engine import tick as eng
    from benchmark.reference.g1ref.engine import state as est
    from benchmark.reference.g1ref.models import robot as rb
    from benchmark.reference.g1ref.mpc import srbd_loop
    return eng, est, rb, srbd_loop
