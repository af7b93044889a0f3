"""Mesh z-buffers and the occlusion plane for the temporal evaluation,
counterpart of implicit_depth_tpu/eval/rasterizer.py.

- The GT mesh's z-buffer, its projected vertices and the fused per-frame
  vertex sampling come from the repository root's csrc/rasterizer.cpp
  (OpenMP over vertices and faces; honours OMP_NUM_THREADS), built with
  `g++ -O3 -fopenmp` into the port's build directory and bound with ctypes.
- The occlusion plane is rendered in closed form in torch, on the device of
  its inputs: a ray-plane hit in f32.
- `load_ply` is a numpy copy of the JAX package's reader.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from implicit_depth_tpu_torch.core import geometry
from implicit_depth_tpu_torch.utils.native_build import build_library

Tensor = torch.Tensor

_lib = None


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    # The OpenMP runtime reads its wait policy when it loads. Passive: its
    # threads sleep between calls. An active wait keeps every core spinning
    # after each call, which starves the thread that feeds the device and
    # torch's own thread pool (a CPU train step ran 4x slower beside a
    # process that rasterized). OMP_WAIT_POLICY set by the caller wins.
    os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
    lib = ctypes.CDLL(str(build_library("rasterizer.cpp", ("-O3", "-fopenmp"))))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.rasterize_depth.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, f32p, f32p,
        ctypes.c_int32, ctypes.c_int32, f32p,
    ]
    lib.project_vertices.argtypes = [f32p, ctypes.c_int64, f32p, f32p, f32p]
    lib.sample_vertex_predictions.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, f32p, f32p, f32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f32p,
    ]
    for fn in (lib.rasterize_depth, lib.project_vertices, lib.sample_vertex_predictions):
        fn.restype = None
    _lib = lib
    return lib


def _camera(cam_T_world_44, K) -> tuple:
    T = np.ascontiguousarray(cam_T_world_44, np.float32)
    K = np.ascontiguousarray(np.asarray(K)[:3, :3], np.float32)
    if T.shape != (4, 4) or K.shape != (3, 3):
        raise ValueError(f"cam_T_world {T.shape} and K {K.shape}: expected (4, 4) and 3x3")
    return T, K


def _mesh(verts_n3, faces_n3) -> tuple:
    """(n, 3) f32 vertices and (m, 3) i32 faces. The C++ reads vertices at
    the faces' indices unchecked: load_ply checks them once per mesh."""
    verts = np.ascontiguousarray(verts_n3, np.float32)
    faces = np.ascontiguousarray(faces_n3, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"mesh shapes {verts.shape}, {faces.shape}: expected (n, 3), (m, 3)")
    return verts, faces


def rasterize_mesh_depth(verts_n3: np.ndarray, faces_n3: np.ndarray, cam_T_world_44: np.ndarray,
                         K_33: np.ndarray, height: int, width: int) -> np.ndarray:
    """(height, width) z-buffer depth of a mesh, 0 where empty. K is the
    3x3 (or the top-left of a 4x4) at the output resolution."""
    lib = _load_lib()
    verts, faces = _mesh(verts_n3, faces_n3)
    T, K = _camera(cam_T_world_44, K_33)
    out = np.zeros((height, width), np.float32)
    lib.rasterize_depth(verts, verts.shape[0], faces, faces.shape[0], T, K, height, width, out)
    return out


def project_mesh_vertices(verts_n3: np.ndarray, cam_T_world_44: np.ndarray,
                          K_33: np.ndarray) -> np.ndarray:
    """(n, 3) -> (n, 3) of (u, v, z_cam); z <= 0 marks a vertex behind the
    camera."""
    lib = _load_lib()
    verts = np.ascontiguousarray(verts_n3, np.float32)
    T, K = _camera(cam_T_world_44, K_33)
    out = np.zeros((verts.shape[0], 3), np.float32)
    lib.project_vertices(verts, verts.shape[0], T, K, out)
    return out


def sample_vertex_predictions(verts_n3: np.ndarray, faces_n3: np.ndarray,
                              cam_T_world_44: np.ndarray, K_33: np.ndarray, pred_hw: np.ndarray,
                              edge_size: int = 4) -> np.ndarray:
    """One frame's vertex-visibility update in one C++ call: the z-buffer,
    the projection, and per vertex the prediction at its pixel (rounded
    half to even) where it lies in frame outside an edge_size border,
    within 5 cm of the z-buffer and the prediction is > 0; -1 elsewhere.
    Returns (n_verts,) f32."""
    lib = _load_lib()
    verts, faces = _mesh(verts_n3, faces_n3)
    T, K = _camera(cam_T_world_44, K_33)
    pred = np.ascontiguousarray(pred_hw, np.float32)
    h, w = pred.shape
    out = np.empty((verts.shape[0],), np.float32)
    lib.sample_vertex_predictions(verts, verts.shape[0], faces, faces.shape[0], T, K, pred, h, w,
                                  edge_size, out)
    return out


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (n, 3) f32, faces (m, 3) i32) of an ascii or
    binary-little-endian PLY of triangles (ScanNet's `_vh_clean_2.ply`, the
    synthetic dataset's procedural mesh). Raises where a face indexes no
    vertex."""
    verts, faces = _read_ply(path)
    if faces.size and (faces.min() < 0 or faces.max() >= verts.shape[0]):
        raise ValueError(f"{path}: face indices outside its {verts.shape[0]} vertices")
    return verts, faces


def _read_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(ln.split()[1] for ln in header if ln.startswith("format"))
        counts, props, current = {}, {}, None
        for ln in header:
            if ln.startswith("element"):
                _, name, cnt = ln.split()
                counts[name] = int(cnt)
                current = name
                props[name] = []
            elif ln.startswith("property") and current:
                props[current].append(ln.split()[1:])

        nv, nf = counts["vertex"], counts["face"]
        if fmt == "ascii":
            verts = np.zeros((nv, 3), np.float32)
            for i in range(nv):
                verts[i] = [float(v) for v in f.readline().split()[:3]]
            faces = np.zeros((nf, 3), np.int32)
            for i in range(nf):
                faces[i] = [int(v) for v in f.readline().split()[1:4]]
            return verts, faces

        tmap = {"float": "f4", "float32": "f4", "double": "f8", "uchar": "u1", "uint8": "u1",
                "int": "i4", "int32": "i4", "uint": "u4", "short": "i2", "ushort": "u2",
                "char": "i1"}
        vdtype = np.dtype([(f"p{i}", "<" + tmap[p[0]]) for i, p in enumerate(props["vertex"])])
        vdata = np.frombuffer(f.read(vdtype.itemsize * nv), dtype=vdtype, count=nv)
        verts = np.stack([vdata["p0"], vdata["p1"], vdata["p2"]], -1).astype(np.float32)
        # face: list <count type> <index type> vertex_indices
        list_prop = props["face"][0]
        fdtype = np.dtype([("n", "<" + tmap[list_prop[1]]), ("idx", "<" + tmap[list_prop[2]], (3,))])
        fdata = np.frombuffer(f.read(fdtype.itemsize * nf), dtype=fdtype, count=nf)
        if not (fdata["n"] == 3).all():
            raise ValueError(f"{path}: only triangle faces are supported")
        return verts, fdata["idx"].astype(np.int32)


def render_plane_depth(anchor_world_T_cam_44: Tensor, plane_distance: Tensor,
                       render_cam_T_world_44: Tensor, K_44: Tensor, height: int, width: int,
                       half_extent: float = 12.8) -> Tensor:
    """Depth in the render camera of the evaluation's occlusion plane: the
    plane z = plane_distance in the anchor camera's frame, spanning
    +-half_extent in x and y. (height, width) f32 on the inputs' device, 0
    where the pixel's ray misses the rectangle or hits it behind the
    camera. The matrix inverses are f32 and never synchronise the device."""
    grid = geometry.pixel_grid(height, width, device=K_44.device)      # (h, w, 3)
    invK = torch.linalg.inv_ex(K_44[:3, :3].float())[0]
    rays_cam = torch.einsum("ij,hwj->hwi", invK, grid)
    # render camera -> anchor camera
    anchor_cam_T_world = torch.linalg.inv_ex(anchor_world_T_cam_44.float())[0]
    world_T_render = torch.linalg.inv_ex(render_cam_T_world_44.float())[0]
    A = anchor_cam_T_world @ world_T_render
    R, o = A[:3, :3], A[:3, 3]
    d = torch.einsum("ij,hwj->hwi", R, rays_cam)                      # ray directions
    denom = d[..., 2]
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    s = (plane_distance - o[2]) / denom
    px = o[0] + s * d[..., 0]
    py = o[1] + s * d[..., 1]
    hit = (s > 0) & (px.abs() <= half_extent) & (py.abs() <= half_extent)
    # the ray's z component is 1, so its parameter s is the depth
    return torch.where(hit, s, torch.zeros_like(s))
