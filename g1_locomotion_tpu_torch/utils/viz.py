"""Trajectory dump and offline plots: the PlotJuggler analogue.

Port of ``g1_locomotion_tpu/utils/viz.py``. The original controller is
watched live through a six-tab PlotJuggler layout (states, contact forces,
contact positions and flags, XY CoM, solve times; MPC_QP_layout.xml); here
a rollout returns a ``TickLog`` of tensors, :func:`save_log` writes it to an
``.npz`` archive and :func:`plot_rollout` renders the same views as static
plots on the host (matplotlib, imported when a plot is drawn). Nothing here
is on the hot path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def save_log(path: str, logs) -> None:
    """Save a ``TickLog`` (any leading batch / period / tick axes) to an
    ``.npz`` archive, one array per field."""
    np.savez_compressed(path, **{name: leaf.detach().cpu().numpy()
                                 for name, leaf in zip(logs._fields, logs)})


def load_log(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def plot_rollout(logs: dict, out_path: str, dt: float = 0.001,
                 scenario: Optional[int] = None,
                 ticks_per_period: int = 40) -> None:
    """Render the PlotJuggler-layout views for one rollout into a PNG grid.

    logs: dict from load_log / TickLog fields. Arrays may have leading
    (scenario, period, tick) axes; `scenario` selects one (default 0 if
    batched). ticks_per_period: control ticks per MPC period, used to shift
    the plan-vs-realized overlay when the log has no period axis.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def flatten(x):
        x = np.asarray(x)
        if scenario is not None and x.ndim >= 4:
            x = x[scenario]
        return x.reshape(-1, *x.shape[-1:]) if x.ndim > 2 else x

    com = flatten(logs["com"])            # (T, 3)
    tau = np.asarray(logs["tau"])
    tau = tau.reshape(-1, tau.shape[-1]) if tau.ndim > 2 else tau
    forces = np.asarray(logs["forces"])
    forces = forces.reshape(-1, 4, 3)
    contact = np.asarray(logs["contact"]).reshape(-1, 4)
    t = np.arange(com.shape[0]) * dt

    fig, axes = plt.subplots(3, 2, figsize=(13, 10))

    ax = axes[0, 0]
    for i, lbl in enumerate("xyz"):
        ax.plot(t, com[:, i], label=f"com {lbl}")
    ax.set_title("CoM states")
    ax.legend(), ax.grid(True)

    ax = axes[0, 1]
    for i, lbl in enumerate(["L-heel", "L-toe", "R-heel", "R-toe"]):
        ax.plot(t, forces[:, i, 2], label=lbl)
    ax.set_title("Contact normal forces [N]")
    ax.legend(), ax.grid(True)

    ax = axes[1, 0]
    ax.plot(com[:, 0], com[:, 1])
    ax.set_title("XY CoM")
    ax.set_xlabel("x [m]"), ax.set_ylabel("y [m]"), ax.grid(True)

    ax = axes[1, 1]
    for i, lbl in enumerate(["L-heel", "L-toe", "R-heel", "R-toe"]):
        ax.step(t, contact[:, i] + i * 1.1, label=lbl, where="post")
    ax.set_title("Contact active flags")
    ax.legend(), ax.grid(True)

    ax = axes[2, 0]
    ax.plot(t, np.abs(tau).max(axis=1))
    ax.set_title("max |joint torque| [Nm]")
    ax.grid(True)

    ax = axes[2, 1]
    if "wbid_pri_res" in logs:
        pr = np.asarray(logs["wbid_pri_res"]).reshape(-1)
        ax.semilogy(t[: len(pr)], np.maximum(pr, 1e-12))
        ax.set_title("WBID QP primal residual")
        ax.grid(True)

    # Plan-vs-realized (the reference's PlotJuggler juxtaposition of
    # /mpc_solution predictions against /srbd_current measurements,
    # MPC_QP_layout.xml:10-100): plan_x1 logged at tick t predicts the state
    # one MPC period later, so shift the plan forward by one period.
    if "plan_x1" in logs:
        plan = np.asarray(logs["plan_x1"])
        if plan.ndim >= 3:
            period_ticks = plan.shape[-2]
            plan = plan.reshape(-1, plan.shape[-1])
        else:
            period_ticks = ticks_per_period
        fig2, axes2 = plt.subplots(2, 2, figsize=(13, 7))
        titles = [("CoM", 3, com), ("CoM velocity", 9, None)]
        for col, (name, off, realized) in enumerate(titles):
            ax = axes2[0, col]
            for i, lbl in enumerate("xyz"):
                ax.plot(
                    t[period_ticks:],
                    plan[: len(t) - period_ticks, off + i],
                    "--",
                    label=f"plan {lbl}",
                )
                if realized is not None:
                    ax.plot(t, realized[:, i], label=f"realized {lbl}", alpha=0.7)
            ax.set_title(f"plan[k=1] vs realized: {name}")
            ax.legend(fontsize=7), ax.grid(True)
        ax = axes2[1, 0]
        err = plan[: len(t) - period_ticks, 3:6] - com[period_ticks:]
        for i, lbl in enumerate("xyz"):
            ax.plot(t[period_ticks:], err[:, i], label=f"err {lbl}")
        ax.set_title("one-period CoM prediction error [m]")
        ax.legend(fontsize=7), ax.grid(True)
        ax = axes2[1, 1]
        if "landing" in logs:
            landing = np.asarray(logs["landing"]).reshape(-1, 3)
            ax.plot(t, landing[: len(t), 0], label="landing x")
            ax.plot(t, landing[: len(t), 1], label="landing y")
            ax.set_title("planned touchdown position")
            ax.legend(fontsize=7), ax.grid(True)
        fig2.tight_layout()
        p2 = Path(out_path)
        fig2.savefig(p2.with_name(p2.stem + "_plan" + p2.suffix), dpi=110)
        plt.close(fig2)

    fig.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
