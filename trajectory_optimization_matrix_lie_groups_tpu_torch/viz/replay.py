"""Optional 3-D trajectory replay via the `rerun` viewer (counterpart of the
JAX `viz/replay.py`).

Host-side twin of the reference's rerun streaming
(`main_SE3ddp_tracking_exact_ms.py:216-250`): log the solved SE(3)
trajectory (and optionally the reference path) as timestamped
Points3D + Transform3D entities.  `rerun` is an optional dependency; when
it is absent, `replay_trajectory` falls back to the quat-pos `.npy` export
(`plots.export_quatpos`'s format) that any external viewer can read, and
`replay_urdf` also writes the parsed robot model as JSON.  Trajectories
(tensors from any device, or arrays) go to the host here; the pose maths is
the port's `ops/se3.py` in float64.
"""

import numpy as np
import torch

from trajectory_optimization_matrix_lie_groups_tpu_torch.ops import se3


def _try_import_rerun():
    try:
        import rerun as rr  # type: ignore

        return rr
    except ImportError:
        return None


def _host64(x):
    """A tensor (any device) or array as a float64 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64))


def _quatpos(qs):
    """(T+1, 4, 4) poses as (T+1, 7) [qw, qx, qy, qz, px, py, pz] numpy."""
    return se3.quatpos_from_matrix(_host64(qs)).numpy()


def replay_trajectory(qs, dt, q_ref=None, app_id="traopt_replay",
                      entity="solution", spawn=True, fallback_path=None):
    """Stream an SE(3) matrix trajectory ``qs`` (T+1, 4, 4) to rerun.

    Returns "rerun" when streamed, else the fallback `.npy` path (written
    when ``fallback_path`` is given) or None.
    """
    qp = _quatpos(qs)
    rr = _try_import_rerun()
    if rr is None:
        if fallback_path is not None:
            np.save(fallback_path, qp)
            return fallback_path
        return None

    rr.init(app_id, spawn=spawn)
    positions = qp[:, 4:]
    if q_ref is not None:
        ref_p = _host64(q_ref).numpy()[:, :3, 3]
        rr.log(f"{entity}/reference", rr.LineStrips3D([ref_p]), static=True)
    for step in range(qp.shape[0]):
        rr.set_time_seconds("sim_time", float(dt) * step)
        rr.log(f"{entity}/position", rr.Points3D(positions[step]))
        w, x, y, z = qp[step, :4]
        rr.log(f"{entity}/body",
               rr.Transform3D(translation=positions[step],
                              rotation=rr.Quaternion(xyzw=[x, y, z, w]),
                              axis_length=1.0))
    return "rerun"


# ---------------------------------------------------------------------------
# URDF robot-model replay (role of visualization/rerun/rerun_loader_urdf.py)
# ---------------------------------------------------------------------------

def _rpy_matrix(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    Ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return Rz @ Ry @ Rx


def _parse_origin(el):
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    if el is not None:
        if el.get("xyz"):
            xyz = np.asarray([float(v) for v in el.get("xyz").split()])
        if el.get("rpy"):
            rpy = np.asarray([float(v) for v in el.get("rpy").split()])
    return xyz, rpy


def _geometry(g, base_dir):
    """One URDF geometry element as a dict, or None for an unknown tag."""
    import os

    if g.tag == "box":
        return dict(type="box", size=[float(v) for v in g.get("size").split()])
    if g.tag == "cylinder":
        return dict(type="cylinder", radius=float(g.get("radius")),
                    length=float(g.get("length")))
    if g.tag == "sphere":
        return dict(type="sphere", radius=float(g.get("radius")))
    if g.tag == "mesh":
        fn = (g.get("filename") or "").replace("package://", "")
        return dict(type="mesh", filename=os.path.join(base_dir, fn),
                    scale=[float(v) for v in (g.get("scale") or "1 1 1").split()])
    return None


def load_urdf(path):
    """Minimal URDF loader (the role of the reference's third-party
    `rerun_loader_urdf.py:19`, stdlib only): returns a dict with

        name:   robot name
        links:  {link_name: [visual, ...]} where each visual is a dict
                geometry in {'box','cylinder','sphere','mesh'} with its
                parameters, plus origin_xyz (3,) / origin_R (3,3)
        joints: [{name, parent, child, origin_xyz, origin_R}]  (all joints
                treated as fixed at their origin: the reference's models
                are rigid bodies whose articulation rides the base pose)
        link_T: {link_name: (R (3,3), p (3,))} pose of each link in the
                base frame, composed through the joint chain.

    Mesh filenames resolve relative to the URDF's directory.
    """
    import os
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    base_dir = os.path.dirname(os.path.abspath(path))
    links = {}
    for link in root.findall("link"):
        visuals = []
        for vis in link.findall("visual"):
            xyz, rpy = _parse_origin(vis.find("origin"))
            geom_el = vis.find("geometry")
            geom = None
            if geom_el is not None:
                for g in geom_el:
                    geom = _geometry(g, base_dir) or geom
            if geom is not None:
                visuals.append(dict(geometry=geom, origin_xyz=xyz, origin_R=_rpy_matrix(rpy)))
        links[link.get("name")] = visuals

    joints = []
    for j in root.findall("joint"):
        xyz, rpy = _parse_origin(j.find("origin"))
        joints.append(dict(name=j.get("name"), parent=j.find("parent").get("link"),
                           child=j.find("child").get("link"), origin_xyz=xyz,
                           origin_R=_rpy_matrix(rpy)))

    # compose link poses in the base frame through the (fixed) joint chain
    children = {j["child"]: j for j in joints}
    link_T = {}

    def pose_of(name):
        if name in link_T:
            return link_T[name]
        j = children.get(name)
        if j is None:
            T = (np.eye(3), np.zeros(3))
        else:
            Rp, pp = pose_of(j["parent"])
            T = (Rp @ j["origin_R"], Rp @ j["origin_xyz"] + pp)
        link_T[name] = T
        return T

    for name in links:
        pose_of(name)
    return dict(name=root.get("name"), links=links, joints=joints, link_T=link_T)


def replay_urdf(urdf_path, qs, dt, q_ref=None, app_id="traopt_replay",
                entity="robot", spawn=True, fallback_path=None):
    """Stream a URDF robot model along an SE(3) trajectory ``qs``
    (T+1, 4, 4): the reference's robot replay
    (`main_SE3ddp_tracking_exact_ms.py:216-250` + `rerun_loader_urdf.py`).

    With `rerun` installed: each link's visuals are logged once under
    ``entity/<link>`` (Boxes3D / cylinders as boxes / Asset3D meshes) at
    their static link-frame offsets, then only the base Transform3D is
    streamed per step (the viewer composes the tree).  Without `rerun`:
    writes ``<fallback_path>.scene.json`` (the parsed model) and
    ``<fallback_path>.npy`` (quat-pos trajectory) so an external viewer
    can replay.  Returns "rerun" or the fallback path or None.
    """
    model = load_urdf(urdf_path)
    qp = _quatpos(qs)
    rr = _try_import_rerun()
    if rr is None:
        if fallback_path is not None:
            import json

            scene = dict(
                name=model["name"],
                links={k: [dict(geometry=v["geometry"], origin_xyz=v["origin_xyz"].tolist())
                           for v in vis] for k, vis in model["links"].items()},
                link_T={k: dict(R=T[0].tolist(), p=T[1].tolist())
                        for k, T in model["link_T"].items()},
            )
            with open(f"{fallback_path}.scene.json", "w") as f:
                json.dump(scene, f)
            np.save(f"{fallback_path}.npy", qp)
            return fallback_path
        return None

    rr.init(app_id, spawn=spawn)
    if q_ref is not None:
        ref_p = _host64(q_ref).numpy()[:, :3, 3]
        rr.log(f"{entity}/reference", rr.LineStrips3D([ref_p]), static=True)
    # static link visuals in the base frame
    for lname, visuals in model["links"].items():
        Rl, pl = model["link_T"][lname]
        for i, vis in enumerate(visuals):
            g = vis["geometry"]
            Rg = Rl @ vis["origin_R"]
            pg = Rl @ vis["origin_xyz"] + pl
            ent = f"{entity}/base/{lname}/vis{i}"
            if g["type"] == "mesh":
                rr.log(ent, rr.Asset3D(path=g["filename"]), static=True)
            elif g["type"] == "box":
                rr.log(ent, rr.Boxes3D(half_sizes=[np.asarray(g["size"]) / 2]), static=True)
            elif g["type"] == "cylinder":
                rr.log(ent, rr.Boxes3D(half_sizes=[[g["radius"], g["radius"],
                                                    g["length"] / 2]]), static=True)
            else:  # sphere
                rr.log(ent, rr.Points3D([[0, 0, 0]], radii=[g["radius"]]), static=True)
            rr.log(ent, rr.Transform3D(translation=pg,
                                       rotation=rr.Quaternion(xyzw=_matrix_quat_xyzw(Rg))),
                   static=True)
    # per-step base transform
    for step in range(qp.shape[0]):
        rr.set_time_seconds("sim_time", float(dt) * step)
        w, x, y, z = qp[step, :4]
        rr.log(f"{entity}/base",
               rr.Transform3D(translation=qp[step, 4:],
                              rotation=rr.Quaternion(xyzw=[x, y, z, w])))
    return "rerun"


def _matrix_quat_xyzw(R):
    """3x3 rotation -> quaternion [x, y, z, w] (host side, Shepperd)."""
    T = np.eye(4)
    T[:3, :3] = R
    q = _quatpos(T)[:4]
    return [q[1], q[2], q[3], q[0]]
