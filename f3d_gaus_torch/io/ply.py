"""PLY import/export: Gaussian sets (3DGS attribute layout) and meshes.

Self-contained binary-little-endian PLY codec (no plyfile or trimesh
dependency).  The Gaussian attribute layout matches the 3DGS
ecosystem convention the reference writes/reads
(scene/gaussian_model.py:191-256 and visualize.py:146-179):

    x y z nx ny nz f_dc_0..2 f_rest_0..(3K-1) opacity scale_0..2 rot_0..3

f_rest is stored CHANNEL-MAJOR (all K coeffs of R, then G, then B) —
the transpose(1, 2).flatten(1) of the torch code.  Values are written
verbatim; whether they are raw (pre-activation, the trainer's convention)
or activated is the caller's contract.
"""
from __future__ import annotations

import io as _io
from typing import Optional

import numpy as np


def _header(elements):
    lines = ["ply", "format binary_little_endian 1.0"]
    for name, count, props in elements:
        lines.append(f"element {name} {count}")
        lines.extend(props)
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def write_gaussian_ply(path, xyz, f_dc, f_rest, opacity, scaling, rotation):
    """xyz (P,3); f_dc (P,3) or (P,1,3); f_rest (P,K,3) or (P,3K); opacity
    (P,) or (P,1); scaling (P,3); rotation (P,4)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    P = len(xyz)
    f_dc = np.asarray(f_dc, np.float32).reshape(P, -1)
    f_rest = np.asarray(f_rest, np.float32)
    if f_rest.ndim == 3:                      # (P, K, 3) -> channel-major
        f_rest = np.transpose(f_rest, (0, 2, 1)).reshape(P, -1)
    opacity = np.asarray(opacity, np.float32).reshape(P, 1)
    scaling = np.asarray(scaling, np.float32).reshape(P, 3)
    rotation = np.asarray(rotation, np.float32).reshape(P, 4)
    normals = np.zeros_like(xyz)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    props = [f"property float {n}" for n in names]
    data = np.concatenate([xyz, normals, f_dc, f_rest, opacity, scaling,
                           rotation], axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(_header([("vertex", P, props)]))
        f.write(data.tobytes())


def read_gaussian_ply(path):
    """Returns dict(xyz (P,3), f_dc (P,1,3), f_rest (P,K,3), opacity (P,1),
    scaling (P,3), rotation (P,4)) — the load_ply contract
    (scene/gaussian_model.py:216-256)."""
    names, data = _read_vertex_block(path)
    col = {n: i for i, n in enumerate(names)}
    P = data.shape[0]
    xyz = data[:, [col["x"], col["y"], col["z"]]]
    f_dc = data[:, [col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]]]
    rest_names = sorted((n for n in names if n.startswith("f_rest_")),
                        key=lambda n: int(n.split("_")[-1]))
    if rest_names:
        rest = data[:, [col[n] for n in rest_names]]
        K = len(rest_names) // 3
        f_rest = rest.reshape(P, 3, K).transpose(0, 2, 1)   # channel-major in
    else:
        f_rest = np.zeros((P, 0, 3), np.float32)
    return {
        "xyz": xyz,
        "f_dc": f_dc.reshape(P, 1, 3),
        "f_rest": f_rest,
        "opacity": data[:, [col["opacity"]]],
        "scaling": data[:, [col["scale_0"], col["scale_1"], col["scale_2"]]],
        "rotation": data[:, [col[f"rot_{i}"] for i in range(4)]],
    }


def write_mesh_ply(path, vertices, faces,
                   vertex_colors: Optional[np.ndarray] = None):
    """Triangle mesh export (what the reference delegates to trimesh)."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    vprops = ["property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        vprops += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    fprops = ["property list uchar int vertex_indices"]
    buf = _io.BytesIO()
    buf.write(_header([("vertex", len(vertices), vprops),
                       ("face", len(faces), fprops)]))
    if vertex_colors is None:
        buf.write(vertices.astype("<f4").tobytes())
    else:
        vc = np.asarray(vertex_colors, np.uint8).reshape(-1, 3)
        rec = np.empty(len(vertices),
                       dtype=[("v", "<f4", 3), ("c", "u1", 3)])
        rec["v"], rec["c"] = vertices, vc
        buf.write(rec.tobytes())
    frec = np.empty(len(faces), dtype=[("n", "u1"), ("i", "<i4", 3)])
    frec["n"], frec["i"] = 3, faces
    buf.write(frec.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def read_mesh_ply(path):
    """Read a mesh written by write_mesh_ply.  Returns (vertices, faces,
    colors-or-None)."""
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:head_end].decode("ascii").splitlines()
    body = raw[head_end:]
    counts, props, cur = {}, {}, None
    for line in header:
        t = line.split()
        if t and t[0] == "element":
            cur = t[1]
            counts[cur] = int(t[2])
            props[cur] = []
        elif t and t[0] == "property" and cur:
            props[cur].append(t[1:])
    nv, nf = counts["vertex"], counts.get("face", 0)
    has_color = any(p[-1] == "red" for p in props["vertex"])
    vdt = [("v", "<f4", 3)] + ([("c", "u1", 3)] if has_color else [])
    varr = np.frombuffer(body, dtype=vdt, count=nv)
    off = varr.nbytes
    farr = np.frombuffer(body[off:], dtype=[("n", "u1"), ("i", "<i4", 3)],
                         count=nf)
    return (varr["v"].copy(), farr["i"].copy(),
            varr["c"].copy() if has_color else None)


def _read_vertex_block(path):
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:head_end].decode("ascii").splitlines()
    names, count, in_vertex = [], 0, False
    fmt = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                count = int(t[2])
        elif t[0] == "property" and in_vertex:
            assert t[1] == "float", f"unsupported property type {t[1]}"
            names.append(t[2])
    assert fmt == "binary_little_endian", f"unsupported format {fmt}"
    data = np.frombuffer(raw[head_end:], dtype="<f4",
                         count=count * len(names)).reshape(count, len(names))
    return names, data.copy()
