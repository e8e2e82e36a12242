"""Export a RobotSpec to a minimal MJCF string (the validation path).

Port of ``g1_locomotion_tpu/models/mjcf.py``: numpy only, so the port keeps
its own copy (importing the reference's module runs its package, which
imports JAX). MuJoCo is a host-side oracle: the closed loop of
``engine/mujoco_bridge.py`` steps it while the controller computes the
torques, and the tests hold the port's dynamics against it. The MJCF is made
from the same JSON asset as the robot model, so both views agree by
construction; collision geometry is approximated (floor plane and foot
boxes spanning the line-contact frames at z = -0.03, g1_23dof.urdf:283-301).
The output is byte-equal to the reference's for every variant and option.
"""

from __future__ import annotations

from typing import List

import numpy as np

from g1_locomotion_tpu_torch.models.urdf import RobotSpec


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (host-side numpy)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            q = np.array(
                [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
            )
        elif i == 1:
            s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
            q = np.array(
                [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
            )
        else:
            s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
            q = np.array(
                [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
            )
    return q / np.linalg.norm(q)


def _fmt(a) -> str:
    return " ".join(f"{x:.12g}" for x in np.atleast_1d(np.asarray(a)).ravel())


def export_mjcf(
    spec: RobotSpec,
    with_floor: bool = False,
    foot_friction: float = 0.8,
    timestep: float = 0.001,
    with_limits: bool = None,
) -> str:
    """Build an MJCF document from the robot spec.

    with_floor=True adds a ground plane and box collision geoms for the feet
    (spanning heel/toe line-contact frames), plus torque actuators for every
    joint — enough to replicate the reference's closed-loop MuJoCo validation
    (1 kHz timestep, ros_run_simulation.py:172).

    with_limits defaults to with_floor: dynamics-oracle exports omit joint
    limits (mj_inverse would otherwise add constraint forces our pure RNEA
    doesn't model), closed-loop exports keep them.
    """
    if with_limits is None:
        with_limits = with_floor
    children: List[List[int]] = [[] for _ in spec.bodies]
    for i, b in enumerate(spec.bodies):
        if b.parent >= 0:
            children[b.parent].append(i)

    lines: List[str] = []
    lines.append(f'<mujoco model="{spec.name}">')
    lines.append(f'  <option timestep="{timestep}" gravity="0 0 -9.80665"/>')
    lines.append('  <compiler angle="radian" balanceinertia="true" inertiafromgeom="false"/>')
    lines.append("  <worldbody>")
    if with_floor:
        lines.append(
            f'    <geom name="floor" type="plane" size="20 20 0.1" friction="{foot_friction} 0.005 0.0001"/>'
        )

    def emit_body(i: int, indent: str) -> None:
        b = spec.bodies[i]
        if b.joint is None:
            pos, quat = np.zeros(3), np.array([1.0, 0, 0, 0])
        else:
            pos = b.joint.origin_xyz
            quat = _mat_to_quat(b.joint.origin_rot)
        lines.append(
            f'{indent}<body name="{b.name}" pos="{_fmt(pos)}" quat="{_fmt(quat)}">'
        )
        if b.joint is None:
            lines.append(f'{indent}  <freejoint name="root"/>')
        else:
            rng = ""
            if with_limits and np.isfinite(b.joint.limit_lower) and np.isfinite(b.joint.limit_upper):
                rng = f' range="{b.joint.limit_lower:.12g} {b.joint.limit_upper:.12g}" limited="true"'
            extra = ' armature="0.01" damping="0.1"' if with_floor else ""
            # Reflected rotor inertia + light damping for closed-loop sims:
            # without armature, low-inertia wrist joints are explosively stiff
            # at the 1 kHz explicit integrator (vendor hardware has gearbox
            # rotor inertia of this order).
            lines.append(
                f'{indent}  <joint name="{b.joint.name}" type="hinge" pos="0 0 0" '
                f'axis="{_fmt(b.joint.axis)}"{rng}{extra}/>'
            )
        if b.mass > 0:
            I = b.inertia
            full = [I[0, 0], I[1, 1], I[2, 2], I[0, 1], I[0, 2], I[1, 2]]
            lines.append(
                f'{indent}  <inertial pos="{_fmt(b.com)}" mass="{b.mass:.12g}" '
                f'fullinertia="{_fmt(full)}"/>'
            )
        if with_floor and b.name.endswith("_ankle_roll_link"):
            # Foot box spanning the heel/toe line-contact frames
            # (x in [-0.05, 0.12], z = -0.03; g1_23dof.urdf:283-301).
            cx = (0.12 - 0.05) / 2.0
            hx = (0.12 + 0.05) / 2.0
            lines.append(
                f'{indent}  <geom name="{b.name}_foot" type="box" '
                f'pos="{cx:.6g} 0 -0.02" size="{hx:.6g} 0.02 0.01" '
                f'friction="{foot_friction} 0.005 0.0001"/>'
            )
        for c in children[i]:
            emit_body(c, indent + "  ")
        lines.append(f"{indent}</body>")

    emit_body(0, "    ")
    lines.append("  </worldbody>")

    if with_floor:
        lines.append("  <actuator>")
        for b in spec.bodies:
            if b.joint is not None:
                eff = b.joint.effort if np.isfinite(b.joint.effort) else 1000.0
                lines.append(
                    f'    <motor name="{b.joint.name}" joint="{b.joint.name}" '
                    f'ctrlrange="{-eff:.12g} {eff:.12g}"/>'
                )
        lines.append("  </actuator>")
    lines.append("</mujoco>")
    return "\n".join(lines)
