"""One process of a multi-process scenario sweep of the PyTorch port.

    python3 tools/torch_distributed_worker.py INIT_METHOD WORLD RANK [--device cpu]
        [--scenarios N] [--periods P]

Joins a ``torch.distributed`` job through ``parallel/mesh.distributed_init``
(``INIT_METHOD`` e.g. ``tcp://localhost:29511``; the card and NCCL by
default, Gloo processes on the CPU with ``--device cpu``), draws the same
domain-randomized batch as every other process (``parallel/sweep.randomize``,
``SweepSpec(N)``, generator seed 0; float32 on the card, float64 on the CPU),
runs its own contiguous rows of it through ``parallel/sweep.run_sweep`` in
the default ``EngineConfig`` and prints the all-reduced ``SweepStats`` as
one JSON line. Exit 0 when the reduced ``n`` is the whole batch.
``tests/test_torch_distributed.py`` starts two Gloo processes and holds
their statistics against one process's run of the same batch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from g1_locomotion_tpu_torch.engine import tick as eng  # noqa: E402
from g1_locomotion_tpu_torch.models.robot import load_robot  # noqa: E402
from g1_locomotion_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from g1_locomotion_tpu_torch.parallel import sweep  # noqa: E402


def sweep_stats(device, scenarios: int, periods: int) -> dict:
    """The sweep's statistics on ``device`` (reduced over the job's
    processes, if any) as floats."""
    dtype = torch.float64 if device.type == "cpu" else torch.float32
    model = load_robot("g1_23dof", device=device, dtype=dtype)
    params = sweep.randomize(sweep.SweepSpec(n_scenarios=scenarios),
                             torch.Generator().manual_seed(0),
                             eng.default_scenario(device=device, dtype=dtype))
    _, _, stats = sweep.run_sweep(eng.ControlLoop(model, eng.EngineConfig()), params,
                                  n_periods=periods)
    return {k: float(v) for k, v in stats._asdict().items()}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("init_method")
    p.add_argument("world", type=int)
    p.add_argument("rank", type=int)
    p.add_argument("--device", default=None)
    p.add_argument("--scenarios", type=int, default=8)
    p.add_argument("--periods", type=int, default=2)
    args = p.parse_args(argv)
    device = pmesh.distributed_init(args.init_method, args.world, args.rank, device=args.device)
    try:
        out = {"rank": args.rank, "world": args.world, "device": str(device),
               **sweep_stats(device, args.scenarios, args.periods)}
        pmesh.coordination_barrier()
    finally:
        dist.destroy_process_group()
    out["ok"] = out["n"] == args.scenarios
    print(json.dumps(out), flush=True)
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
