"""Per-window occlusion-flip counting on the device, counterpart of
implicit_depth_tpu/eval/vertex_scorer.py.

The GT mesh's vertices live on the net's device. Per window only the
host-rasterized (L, h, w) z-buffers go up, and one scalar, the window's
flip count, comes back: the (L, h, w) prediction download and the
million-vertex host sampling loop leave the steady-state path. The
rasterization itself stays in C++ (eval/rasterizer.py).

The numerics are those of csrc/rasterizer.cpp::sample_vertex_predictions
(f32 elementwise ops in its order, round-half-to-even pixel lookup, the
5 cm z test, the edge mask), followed by
TemporalEvaluator.compute_vertex_occlusion_changes (-1 -> NaN, binarised
at 0.5, |diff| summed where both frames saw the vertex).
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


class DeviceVertexScorer:
    """Construct once per scene (uploads the vertices), then per plane
    window call `window_flips(preds, zbufs, cams, Ks)`."""

    def __init__(self, verts_n3: np.ndarray, height: int, width: int, device,
                 edge_size: int = 4):
        self.n_verts = int(verts_n3.shape[0])
        self.height, self.width, self.edge_size = int(height), int(width), int(edge_size)
        self.device = torch.device(device)
        self.verts = torch.as_tensor(np.ascontiguousarray(verts_n3, np.float32)).to(self.device)

    def frame_values(self, pred_hw: Tensor, zbuf_hw: Tensor, cam_T_world: Tensor,
                     K: Tensor) -> Tensor:
        """(n_verts,) f32: the prediction at each visible vertex, -1
        elsewhere (csrc/rasterizer.cpp::sample_vertex_predictions). K is
        3x3 or 4x4."""
        h, w, e = self.height, self.width, self.edge_size
        T = cam_T_world.float()
        x, y, z = self.verts.unbind(-1)
        cxp = T[0, 0] * x + T[0, 1] * y + T[0, 2] * z + T[0, 3]
        cyp = T[1, 0] * x + T[1, 1] * y + T[1, 2] * z + T[1, 3]
        czp = T[2, 0] * x + T[2, 1] * y + T[2, 2] * z + T[2, 3]
        front = czp > 1e-6
        zs = torch.where(front, czp, torch.ones_like(czp))
        uf = K[0, 0].float() * cxp / zs + K[0, 2].float()
        vf = K[1, 1].float() * cyp / zs + K[1, 2].float()
        # torch.round rounds half to even, as std::nearbyint and np.round
        u = torch.round(uf - 0.5).to(torch.int64)
        v = torch.round(vf - 0.5).to(torch.int64)
        inb = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        uc, vc = u.clamp(0, w - 1), v.clamp(0, h - 1)
        lin = vc * w + uc
        sampled_z = zbuf_hw.reshape(-1)[lin]
        sampled_p = pred_hw.float().reshape(-1)[lin]
        masked = (uc < e) | (uc >= w - e) | (vc < e) | (vc >= h - e)
        p = torch.where(masked, torch.full_like(sampled_p, -1.0), sampled_p)
        valid = inb & (sampled_z > 0) & ((czp - sampled_z).abs() < 0.05) & (p > 0)
        return torch.where(valid, p, torch.full_like(p, -1.0))

    def window_flips(self, preds: Tensor, zbufs: np.ndarray, cams: np.ndarray,
                     Ks: np.ndarray) -> Tensor:
        """The window's flip count as a device scalar (asynchronous).
        preds (L, h, w) on the device; zbufs (L, h, w), cams (L, 4, 4) and Ks
        (L, 3 or 4, 3 or 4) host arrays."""
        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(
                self.device, non_blocking=True)

        zbufs, cams, Ks = up(zbufs), up(cams), up(Ks)
        vals = torch.stack([self.frame_values(preds[i], zbufs[i], cams[i], Ks[i])
                            for i in range(preds.shape[0])])              # (L, n)
        nanv = torch.where(vals < 0, torch.full_like(vals, float("nan")), vals)
        binv = torch.where(nanv > 0.5, torch.ones_like(nanv),
                           torch.where(nanv < 0.5, torch.zeros_like(nanv), nanv))
        return torch.nansum((binv[1:] - binv[:-1]).abs())
