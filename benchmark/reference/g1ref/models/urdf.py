"""Generic URDF parser -> RobotSpec (host-side, numpy and stdlib only).

This package's own copy of ``g1_locomotion_tpu/models/urdf.py`` (the JAX
package's ``__init__`` imports JAX, so no module of it is imported here).
It replaces the reference's reliance on xbot2_interface/Pinocchio URDF
loading (reference wbid.py:20 ``xbi.ModelInterface2(urdf)``): a parser
producing a plain-Python :class:`RobotSpec` that the model builder
(:mod:`benchmark.reference.g1ref.models.robot`) turns into tensors.

Semantics implemented (matching Pinocchio's URDF reduction, which the reference's
joint ordering depends on — see config.py q layout):

* One *movable body* per non-fixed joint, plus the root body (child of the
  ``floating`` joint, or the first link if the tree is rooted free-standing).
* ``fixed`` joints are welded: the child link's inertia is fused into the
  nearest movable ancestor via the parallel-axis theorem, and the child link
  becomes a *named frame* on that body (this is how the foot contact frames
  ``*_foot_line_contact_{lower,upper}`` / ``*_foot_point_contact`` and the hand
  point contacts are represented, g1_23dof.urdf:283-301,524-541,855-858).
* Movable joints keep URDF file order (depth-first as written), which for the
  G1 descriptions reproduces the Pinocchio ordering of config.py:2-39.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

Vec3 = Tuple[float, float, float]


def _rpy_matrix(r: float, p: float, y: float) -> np.ndarray:
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def _parse_origin(elem: Optional[ET.Element]) -> Tuple[np.ndarray, np.ndarray]:
    if elem is None:
        return np.zeros(3), np.eye(3)
    xyz = np.array([float(v) for v in elem.get("xyz", "0 0 0").split()])
    rpy = [float(v) for v in elem.get("rpy", "0 0 0").split()]
    return xyz, _rpy_matrix(*rpy)


@dataclass
class LinkInertial:
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # Inertia about the CoM, in the link frame (already rotated out of the
    # inertial-origin frame during parsing).
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))


@dataclass
class JointSpec:
    name: str
    jtype: str  # 'revolute' | 'continuous' | 'prismatic' | 'fixed' | 'floating'
    parent_link: str
    child_link: str
    origin_xyz: np.ndarray
    origin_rot: np.ndarray
    axis: np.ndarray
    limit_lower: float = -np.inf
    limit_upper: float = np.inf
    effort: float = np.inf
    velocity: float = np.inf


@dataclass
class BodySpec:
    """A movable body: the composite of one link plus all fixed descendants."""

    name: str  # name of the primary (movable-joint child) link
    parent: int  # index of parent movable body, -1 for root
    joint: Optional[JointSpec]  # None for the root body
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))  # about CoM


@dataclass
class FrameSpec:
    """A named frame rigidly attached to a movable body (fixed link or site)."""

    name: str
    body: int
    xyz: np.ndarray
    rot: np.ndarray


@dataclass
class RobotSpec:
    name: str
    bodies: List[BodySpec]
    frames: List[FrameSpec]
    floating_base: bool

    @property
    def joint_names(self) -> List[str]:
        return [b.joint.name for b in self.bodies if b.joint is not None]

    def frame_index(self, name: str) -> int:
        for i, f in enumerate(self.frames):
            if f.name == name:
                return i
        raise KeyError(name)


def _fuse_inertia(
    a_mass: float,
    a_com: np.ndarray,
    a_I: np.ndarray,
    b_mass: float,
    b_com: np.ndarray,
    b_I: np.ndarray,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Combine two (mass, com, I_com) triplets expressed in the same frame."""
    m = a_mass + b_mass
    if m == 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = (a_mass * a_com + b_mass * b_com) / m

    def shift(mass, c, I):
        d = c - com
        return I + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

    return m, com, shift(a_mass, a_com, a_I) + shift(b_mass, b_com, b_I)


def parse_urdf(urdf_string: str) -> RobotSpec:
    root = ET.fromstring(urdf_string)
    name = root.get("name", "robot")

    links: Dict[str, LinkInertial] = {}
    for link in root.findall("link"):
        li = LinkInertial()
        inertial = link.find("inertial")
        if inertial is not None:
            xyz, rot = _parse_origin(inertial.find("origin"))
            mass_el = inertial.find("mass")
            li.mass = float(mass_el.get("value")) if mass_el is not None else 0.0
            inertia_el = inertial.find("inertia")
            if inertia_el is not None:
                ixx = float(inertia_el.get("ixx", 0))
                ixy = float(inertia_el.get("ixy", 0))
                ixz = float(inertia_el.get("ixz", 0))
                iyy = float(inertia_el.get("iyy", 0))
                iyz = float(inertia_el.get("iyz", 0))
                izz = float(inertia_el.get("izz", 0))
                I_local = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                # Rotate inertia from the inertial-origin frame into the link frame.
                li.inertia = rot @ I_local @ rot.T
            li.com = xyz
        links[link.get("name")] = li

    joints: List[JointSpec] = []
    for joint in root.findall("joint"):
        jtype = joint.get("type")
        xyz, rot = _parse_origin(joint.find("origin"))
        axis_el = joint.find("axis")
        axis = (
            np.array([float(v) for v in axis_el.get("xyz").split()])
            if axis_el is not None
            else np.array([1.0, 0.0, 0.0])
        )
        limit_el = joint.find("limit")
        lower, upper, effort, velocity = -np.inf, np.inf, np.inf, np.inf
        if limit_el is not None:
            lower = float(limit_el.get("lower", -np.inf))
            upper = float(limit_el.get("upper", np.inf))
            effort = float(limit_el.get("effort", np.inf))
            velocity = float(limit_el.get("velocity", np.inf))
        joints.append(
            JointSpec(
                name=joint.get("name"),
                jtype=jtype,
                parent_link=joint.find("parent").get("link"),
                child_link=joint.find("child").get("link"),
                origin_xyz=xyz,
                origin_rot=rot,
                axis=axis,
                limit_lower=lower,
                limit_upper=upper,
                effort=effort,
                velocity=velocity,
            )
        )

    child_of: Dict[str, JointSpec] = {j.child_link: j for j in joints}

    # Find the root movable link: child of a 'floating' joint, or a link that is
    # nobody's child (excluding a bare 'world' link).
    floating = [j for j in joints if j.jtype == "floating"]
    if floating:
        root_link = floating[0].child_link
        floating_base = True
    else:
        all_children = set(child_of.keys())
        candidates = [ln for ln in links if ln not in all_children and ln != "world"]
        if not candidates:
            raise ValueError("no root link found")
        root_link = candidates[0]
        floating_base = False

    # Movable joints in file order, reachable from the root.
    movable_types = ("revolute", "continuous", "prismatic")

    bodies: List[BodySpec] = [BodySpec(name=root_link, parent=-1, joint=None)]
    link_to_body: Dict[str, int] = {root_link: 0}
    # Placement of each welded link w.r.t. its owning movable body's frame.
    link_offset: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
        root_link: (np.zeros(3), np.eye(3))
    }
    frames: List[FrameSpec] = [FrameSpec(root_link, 0, np.zeros(3), np.eye(3))]

    # Iterate joints in file order until fixpoint (parents may appear later in
    # pathological files; URDFs are usually topologically ordered).
    pending = [j for j in joints if j.jtype != "floating"]
    progress = True
    while pending and progress:
        progress = False
        remaining = []
        for j in pending:
            if j.parent_link not in link_to_body:
                remaining.append(j)
                continue
            progress = True
            parent_body = link_to_body[j.parent_link]
            p_xyz, p_rot = link_offset[j.parent_link]
            j_xyz = p_rot @ j.origin_xyz + p_xyz
            j_rot = p_rot @ j.origin_rot
            if j.jtype in movable_types:
                body_idx = len(bodies)
                li = links.get(j.child_link, LinkInertial())
                # Re-anchor the joint spec with the composed offset from the
                # parent movable body frame.
                jj = JointSpec(
                    name=j.name,
                    jtype=j.jtype,
                    parent_link=j.parent_link,
                    child_link=j.child_link,
                    origin_xyz=j_xyz,
                    origin_rot=j_rot,
                    axis=j.axis,
                    limit_lower=j.limit_lower,
                    limit_upper=j.limit_upper,
                    effort=j.effort,
                    velocity=j.velocity,
                )
                bodies.append(
                    BodySpec(
                        name=j.child_link,
                        parent=parent_body,
                        joint=jj,
                        mass=li.mass,
                        com=li.com.copy(),
                        inertia=li.inertia.copy(),
                    )
                )
                link_to_body[j.child_link] = body_idx
                link_offset[j.child_link] = (np.zeros(3), np.eye(3))
                frames.append(FrameSpec(j.child_link, body_idx, np.zeros(3), np.eye(3)))
            elif j.jtype == "fixed":
                li = links.get(j.child_link, LinkInertial())
                body = bodies[parent_body]
                com_in_body = j_rot @ li.com + j_xyz
                I_in_body = j_rot @ li.inertia @ j_rot.T
                body.mass, body.com, body.inertia = _fuse_inertia(
                    body.mass, body.com, body.inertia, li.mass, com_in_body, I_in_body
                )
                link_to_body[j.child_link] = parent_body
                link_offset[j.child_link] = (j_xyz, j_rot)
                frames.append(FrameSpec(j.child_link, parent_body, j_xyz, j_rot))
            else:
                raise NotImplementedError(f"joint type {j.jtype}")
        pending = remaining

    # Root body inertia.
    li = links.get(root_link, LinkInertial())
    bodies[0].mass, bodies[0].com, bodies[0].inertia = li.mass, li.com.copy(), li.inertia.copy()

    return RobotSpec(name=name, bodies=bodies, frames=frames, floating_base=floating_base)


def spec_to_dict(spec: RobotSpec) -> dict:
    """Serialize a RobotSpec into a plain-JSON dict (asset format)."""
    return {
        "name": spec.name,
        "floating_base": spec.floating_base,
        "bodies": [
            {
                "name": b.name,
                "parent": b.parent,
                "mass": b.mass,
                "com": b.com.tolist(),
                "inertia": b.inertia.tolist(),
                "joint": None
                if b.joint is None
                else {
                    "name": b.joint.name,
                    "type": b.joint.jtype,
                    "origin_xyz": b.joint.origin_xyz.tolist(),
                    "origin_rot": b.joint.origin_rot.tolist(),
                    "axis": b.joint.axis.tolist(),
                    "lower": b.joint.limit_lower,
                    "upper": b.joint.limit_upper,
                    "effort": b.joint.effort,
                    "velocity": b.joint.velocity,
                },
            }
            for b in spec.bodies
        ],
        "frames": [
            {"name": f.name, "body": f.body, "xyz": f.xyz.tolist(), "rot": f.rot.tolist()}
            for f in spec.frames
        ],
    }


def spec_from_dict(d: dict) -> RobotSpec:
    bodies = []
    for bd in d["bodies"]:
        j = bd["joint"]
        joint = (
            None
            if j is None
            else JointSpec(
                name=j["name"],
                jtype=j["type"],
                parent_link="",
                child_link=bd["name"],
                origin_xyz=np.array(j["origin_xyz"]),
                origin_rot=np.array(j["origin_rot"]),
                axis=np.array(j["axis"]),
                limit_lower=j["lower"],
                limit_upper=j["upper"],
                effort=j["effort"],
                velocity=j["velocity"],
            )
        )
        bodies.append(
            BodySpec(
                name=bd["name"],
                parent=bd["parent"],
                joint=joint,
                mass=bd["mass"],
                com=np.array(bd["com"]),
                inertia=np.array(bd["inertia"]),
            )
        )
    frames = [
        FrameSpec(f["name"], f["body"], np.array(f["xyz"]), np.array(f["rot"]))
        for f in d["frames"]
    ]
    return RobotSpec(
        name=d["name"], bodies=bodies, frames=frames, floating_base=d["floating_base"]
    )
