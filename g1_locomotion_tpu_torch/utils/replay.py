"""3D kinematic scene replay with contact-force arrows: the rviz analogue.

Port of ``g1_locomotion_tpu/utils/replay.py``. The original controller
publishes a live rviz scene per tick (the robot model and TF tree, a wrench
display per contact point, the MPC horizon and swing markers; viz.py:65-264).
Here a rollout logs the configuration per tick (``EngineConfig.log_q`` ->
``TickLog.q``) and this module renders the scene offline on the host:
the kinematic skeleton by the port's FK on the model's device, the foot
soles, per-contact force arrows, the CoM trace and the planned landing, as
keyframe PNGs and an animated GIF (matplotlib, imported when a frame is
drawn). Nothing here is on the hot path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from g1_locomotion_tpu_torch.models import robot as rb
from g1_locomotion_tpu_torch.wbid.stack import StackIndices


def _fk(model, q: np.ndarray):
    """FK of one configuration on the model's device."""
    return rb.fk(model, torch.as_tensor(np.asarray(q), dtype=model.dtype,
                                        device=model.device)[None])


def skeleton_segments(model, q: np.ndarray) -> np.ndarray:
    """(nb - 1, 2, 3) world segments parent origin -> body origin: the
    TF-tree skeleton rviz draws through its RobotModel display."""
    p = _fk(model, q).p[0].double().cpu().numpy()
    segs = np.empty((model.nb - 1, 2, 3))
    for b in range(1, model.nb):
        segs[b - 1, 0] = p[model.parent[b]]
        segs[b - 1, 1] = p[b]
    return segs


def contact_points(model, idx, q: np.ndarray) -> np.ndarray:
    """(4, 3) world positions of the contact frames (LH, LT, RH, RT)."""
    X = _fk(model, q)
    return np.stack([rb.frame_pose(model, X, f).p[0].double().cpu().numpy()
                     for f in idx.contacts])


def render_frame(
    ax,
    model,
    idx,
    q: np.ndarray,
    forces: Optional[np.ndarray] = None,   # (4, 3) per-contact GRF
    landing: Optional[np.ndarray] = None,  # (3,) planned touchdown
    com_trace: Optional[np.ndarray] = None,  # (T, 3) CoM history up to now
    force_scale: float = 0.002,            # m per N (arrow length)
) -> None:
    """Draw one scene into a 3D axes: skeleton, soles, GRF arrows, CoM."""
    segs = skeleton_segments(model, q)
    for a, b in segs:
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                color="#456", lw=1.8)
    cpos = contact_points(model, idx, q)
    # Foot soles: heel->toe line per foot.
    for f0, f1, side in ((0, 1, "L"), (2, 3, "R")):
        ax.plot(cpos[[f0, f1], 0], cpos[[f0, f1], 1], cpos[[f0, f1], 2],
                color="#222", lw=3.0)
    if forces is not None:
        forces = np.asarray(forces).reshape(4, 3)
        for c in range(4):
            f = forces[c] * force_scale
            if np.linalg.norm(f) < 1e-6:
                continue
            ax.quiver(cpos[c, 0], cpos[c, 1], cpos[c, 2],
                      f[0], f[1], f[2], color="#c33", lw=1.5,
                      arrow_length_ratio=0.15)
    if landing is not None and np.isfinite(landing).all():
        ax.scatter([landing[0]], [landing[1]], [landing[2]],
                   marker="x", color="#2a2", s=60)
    if com_trace is not None and len(com_trace):
        ax.plot(com_trace[:, 0], com_trace[:, 1], com_trace[:, 2],
                color="#28c", lw=1.0, alpha=0.8)
        ax.scatter(*com_trace[-1], color="#28c", s=25)


def render_replay(
    model,
    qs: np.ndarray,                       # (T, nq) logged configurations
    forces: Optional[np.ndarray] = None,  # (T, 4, 3) or (T, 12)
    landings: Optional[np.ndarray] = None,  # (T, 3)
    coms: Optional[np.ndarray] = None,    # (T, 3)
    out_dir: str = "replay_out",
    stride: int = 100,
    gif: bool = True,
    dt: float = 0.001,
) -> Sequence[str]:
    """Render keyframe PNGs (every ``stride`` ticks) + an animated GIF.

    Returns the list of written file paths. The camera follows the CoM so
    long walks stay in frame (rviz's orbit camera equivalent)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idx = StackIndices.from_model(model)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    qs = np.asarray(qs)
    T = qs.shape[0]
    frames = list(range(0, T, max(1, stride)))
    written = []

    def draw(axes, t):
        axes.cla()
        f_t = None if forces is None else np.asarray(forces[t])
        l_t = None if landings is None else np.asarray(landings[t])
        c_tr = None if coms is None else np.asarray(coms[: t + 1 : 10])
        render_frame(axes, model, idx, qs[t], f_t, l_t, c_tr)
        cx, cy = qs[t, 0], qs[t, 1]
        axes.set_xlim(cx - 0.6, cx + 0.6)
        axes.set_ylim(cy - 0.6, cy + 0.6)
        axes.set_zlim(0.0, 1.2)
        axes.set_box_aspect((1, 1, 1))
        axes.set_title(f"t = {t * dt:.2f} s")

    fig = plt.figure(figsize=(6, 6))
    axp = fig.add_subplot(111, projection="3d")
    for t in frames:
        draw(axp, t)
        path = out / f"frame_{t:06d}.png"
        fig.savefig(path, dpi=80)
        written.append(str(path))
    if gif and len(frames) > 1:
        from matplotlib.animation import FuncAnimation, PillowWriter

        anim = FuncAnimation(
            fig, lambda t: draw(axp, t), frames=frames, interval=50
        )
        gif_path = out / "replay.gif"
        anim.save(gif_path, writer=PillowWriter(fps=12))
        written.append(str(gif_path))
    plt.close(fig)
    return written
