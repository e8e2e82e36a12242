"""CLI for the demo configs of the PyTorch port.

    python -m g1_locomotion_tpu_torch.api.cli <demo> [options] [--device cpu]

Port of ``g1_locomotion_tpu/api/cli.py``: the reference's seven
subcommands with their options, each wired to its demo in ``api/demos.py``.
The demos run on the card at float32 unless ``--device cpu`` is given, then
at float64 (the reference's rule: float64 where the backend is the CPU);
``walking-mujoco`` runs at float64 always, as the reference's.
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="g1_locomotion_tpu_torch")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs at float64)")
    sub = p.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("walking", help="config 1: straight-line walking demo")
    w.add_argument("--seconds", type=float, default=6.5)
    w.add_argument("--vx", type=float, default=0.1)
    w.add_argument("--steps", type=int, default=8)
    w.add_argument("--log", type=str, default=None)
    w.add_argument("--plot", type=str, default=None)

    wm = sub.add_parser("walking-mujoco",
                        help="config 1 under real MuJoCo contacts (6 steps + settle)")
    wm.add_argument("--steps", type=int, default=6)
    wm.add_argument("--vx", type=float, default=0.1)
    wm.add_argument("--view", action="store_true",
                    help="live MuJoCo viewer during the run; needs a display")

    pr = sub.add_parser("push-recovery", help="config 2: N=20 push recovery")
    pr.add_argument("--push-x", type=float, default=0.25)
    pr.add_argument("--push-y", type=float, default=0.15)
    pr.add_argument("--horizon", type=int, default=20)

    gs = sub.add_parser("gait-sweep", help="config 3: batched MPC sweep")
    gs.add_argument("--batch", type=int, default=4096)

    sub.add_parser("wbid-29dof", help="config 4: 29-DoF WBID cascade")
    sub.add_parser("carry-walk", help="config 4 walking: 29-DoF+hands carry-walk (hand hold tasks)")

    ps = sub.add_parser("pod-sweep", help="config 5: domain-randomized scenario sweep")
    ps.add_argument("--scenarios", type=int, default=4096)
    ps.add_argument("--periods", type=int, default=5)

    args = p.parse_args(argv)
    from g1_locomotion_tpu_torch.api import demos

    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    kw = {"device": args.device, "dtype": torch.float64 if cpu else torch.float32}
    if args.cmd == "walking":
        out = demos.demo_walking(seconds=args.seconds, v_cmd=(args.vx, 0.0), n_steps=args.steps,
                                 log_path=args.log, plot_path=args.plot, **kw)
    elif args.cmd == "walking-mujoco":
        out = demos.demo_walking_mujoco(n_steps=args.steps, v_cmd=(args.vx, 0.0),
                                        view=args.view, device=args.device)
    elif args.cmd == "push-recovery":
        out = demos.demo_push_recovery(push_velocity=(args.push_x, args.push_y),
                                       horizon=args.horizon, **kw)
    elif args.cmd == "gait-sweep":
        out = demos.demo_gait_sweep(batch=args.batch, **kw)
    elif args.cmd == "wbid-29dof":
        out = demos.demo_wbid_29dof(**kw)
    elif args.cmd == "carry-walk":
        out = demos.demo_carry_walk(**kw)
    else:
        out = demos.demo_pod_sweep(scenarios=args.scenarios, n_periods=args.periods, **kw)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
