"""BDNet — the implicit binary-depth model (torch): dense eval forward,
depth from the binary oracle, and the BD training forward.

Counterpart of implicit_depth_tpu/models/bd_net.py for the paths that
`forward_val`, `forward_infer_depth` and `__call__` (here `forward`) run:
image encoder, matching encoder on all views, a cost volume, CVEncoder ->
decoder (DecoderPP or SkipDecoder), and the query heads: the scale-0 head
once per rendered-depth plane (eval), twelve times per pixel in a
bisection over depth (`forward_infer_depth`),
or every scale at sparse rays through `factored` and ops/ray_head.py
(training). Volumes (`feature_volume_type`), as the JAX package branches:
- `mlp_feature_volume`: the metadata volume through ops/fused_volume.py
  (kernel #1 on CUDA tensors, the training forward through the
  differentiable `fused_train`, #1 and #2), the plain versions on CPU
  tensors;
- `simple_cost_volume`: the dot-product volume over the flat warp
  (volumes/cost_volume.py::build_warped_views, kernels #5 and #6 of
  ops/warp_kernel.py), in eval and in training alike;
- `zero_cost_volume`: the ablation volume of zeros.
With `use_prior` the heads take one more input, the temporal prior: in
eval the previous frame's prediction warped through the rendered depth
(`sample_prior`, -1 where there is none), in training the augmented
ground-truth occupancy (`augment_prior`, from uniform draws the caller
hands in). The encoders and the decoder are chosen by name as in the JAX
package (models/depth_net.py: `image_encoder`, `matching_encoder`,
`depth_decoder`); both decoders give each scale NUM_CH_DEC channels, so
the query heads are the same.

Flip augmentation follows the reference: images flipped, matching features
unflipped before the volume, the volume re-flipped before the CV encoder,
decoder features unflipped at the end.

Batch dicts use the JAX package's NHWC layout (see its module docstring);
the conv stacks run in NCHW. Pose products, the volume geometry and the
prior's geometry are f32 at full precision, also under autocast.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from implicit_depth_tpu_torch.core import geometry
from implicit_depth_tpu_torch.core.sampling import grid_sample
from implicit_depth_tpu_torch.models.decoders import NUM_CH_DEC, BinaryMLPNetwork, CVEncoder
from implicit_depth_tpu_torch.models.depth_net import (VOLUME_TYPES, depth_decoder, image_encoder,
                                                       matching_encoder)
from implicit_depth_tpu_torch.models.volume_mlp import MetadataVolumeMLP
from implicit_depth_tpu_torch.utils.profiling import span
from implicit_depth_tpu_torch.volumes import cost_volume as cv

Tensor = torch.Tensor

SCALES = (0, 1, 2, 3)
# query heads only the training forward runs; an eval-initialised flax tree
# does not hold them
TRAIN_ONLY_PREFIXES = tuple(f"binary_mlp.s{s}_" for s in SCALES[1:])


def prior_noise_shapes(depths_shape) -> list:
    """The shape of each scale's prior, (b, N_s, S), for sampled depths of
    shape (b, N, S): scale s takes every (s+1)-th ray."""
    b, n, s = depths_shape
    return [(b, -(-n // (scale + 1)), s) for scale in SCALES]


def draw_prior_noise(depths_shape, dtype: torch.dtype, generator: torch.Generator) -> list:
    """The uniform draws of the training prior's augmentation, per scale a
    pair (offset, flip) of U[0, 1) tensors of prior_noise_shapes(...) in
    `dtype`, on the generator's device."""
    return [tuple(torch.rand(shape, generator=generator, dtype=dtype,
                             device=generator.device) for _ in range(2))
            for shape in prior_noise_shapes(depths_shape)]


def augment_prior(sub_depths: Tensor, sub_target: Tensor, u_offset: Tensor,
                  u_flip: Tensor) -> Tensor:
    """The training prior of one scale from its draws, in the draws' dtype
    (the JAX package's run_mlp_train): the ground-truth occupancy
    (sub_depths < sub_target), moved toward 0.5 by u_offset * 0.45, flipped
    to 1 - prior where u_flip < 0.5, and -1 (no prior) where u_flip < 0.25.
    sub_depths (b, N_s, S), sub_target (b, N_s)."""
    dt = u_offset.dtype
    prior = (sub_depths < sub_target[..., None]).to(dt)
    offset = u_offset * 0.45
    prior = torch.where(prior == 1.0, prior - offset, prior + offset)
    prior = torch.where(u_flip < 0.5, 1.0 - prior, prior)
    return torch.where(u_flip < 0.25, torch.full_like(prior, -1.0), prior)


class BDNet(nn.Module):
    def __init__(
        self,
        image_encoder_name: str = "efficientnet",
        feature_volume_type: str = "mlp_feature_volume",
        depth_decoder_name: str = "unet_pp",
        matching_encoder_type: str = "resnet",
        matching_scale: int = 1,
        matching_feature_dims: int = 16,
        num_depth_bins: int = 64,
        num_src_views: int = 7,
        min_matching_depth: float = 0.25,
        max_matching_depth: float = 5.0,
        use_prior: bool = False,
        bd_sigmoid_multiplier: float = 1.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if feature_volume_type not in VOLUME_TYPES:
            raise NotImplementedError(f"feature volume {feature_volume_type} is not ported")
        self.feature_volume_type = feature_volume_type
        self.bd_sigmoid_multiplier = bd_sigmoid_multiplier
        self.matching_scale = matching_scale
        self.use_prior = use_prior
        self.num_depth_bins = num_depth_bins
        self.min_matching_depth = min_matching_depth
        self.max_matching_depth = max_matching_depth
        self.compute_dtype = compute_dtype

        self.encoder = image_encoder(image_encoder_name)
        enc_ch = list(self.encoder.num_ch_enc)
        self.matching = matching_encoder(matching_encoder_type, matching_feature_dims)
        if feature_volume_type == "mlp_feature_volume":
            self.volume_mlp = MetadataVolumeMLP(num_src_views=num_src_views,
                                                matching_dim=matching_feature_dims)
        self.cv_encoder = CVEncoder(num_depth_bins, enc_ch[matching_scale:])
        self.decoder = depth_decoder(depth_decoder_name,
                                     enc_ch[:matching_scale] + list(self.cv_encoder.num_ch_outs),
                                     regression=False)
        # fc0 rows: the query depth, the features [, the prior]
        self.binary_mlp = BinaryMLPNetwork([NUM_CH_DEC[s] + 1 + int(use_prior) for s in SCALES])

    def cast_to_compute_dtype(self) -> "BDNet":
        """Casts the conv and dense stacks to the compute dtype. The volume
        MLP stays f32: its kernel takes f32 operands besides the features."""
        for name in ("encoder", "matching", "cv_encoder", "decoder", "binary_mlp"):
            getattr(self, name).to(self.compute_dtype)
        return self

    # ---------------- shared trunk ----------------
    def trunk(self, cur_data: dict, src_data: dict, flip: bool = False,
              train: bool = False, stop_at: str = "") -> dict:
        """Encoders + cost volume + U-Net. Returns per-scale decoder features
        (NCHW, unflipped), the lowest-cost depth and the depth planes. `train`
        runs the differentiable metadata volume (kernels #1 and #2); the dot
        volume is differentiable either way (kernels #5 and #6).

        `stop_at` is the profilers' probe (cli/profile_eval.py,
        cli/roofline.py), with the JAX package's returns: "encoder" ->
        {"features": image encoder features}; "matching" -> {"features":
        [m_cur, m_src] + encoder features} (the matching features NHWC,
        unflipped); "volume" -> {"features": [the (b, d, h, w) volume] +
        encoder features}, before the volume is re-flipped (the zero volume
        does not stop there, as in the JAX package); "cv_encoder" ->
        {"features": CV encoder features}; "" runs the whole trunk.

        Each stage runs in its span (utils/profiling.py::SPANS), which an
        early return closes."""
        cdt = self.compute_dtype
        with span("idt.trunk.encoder"):
            cur_image = cur_data["image"].permute(0, 3, 1, 2)         # (b, 3, h, w)
            src_image = src_data["image"].permute(0, 1, 4, 2, 3)      # (b, k, 3, h, w)
            if flip:
                cur_image, src_image = cur_image.flip(3), src_image.flip(4)
            b, k = src_image.shape[:2]
            no_autocast = torch.autocast(cur_image.device.type, enabled=False)

            with no_autocast:
                src_T_cur = torch.einsum("bkij,bjl->bkil", src_data["cam_T_world"].float(),
                                         cur_data["world_T_cam"].float())
                cur_T_src = torch.einsum("bij,bkjl->bkil", cur_data["cam_T_world"].float(),
                                         src_data["world_T_cam"].float())

            enc_feats = self.encoder(cur_image.to(cdt))
            if stop_at == "encoder":
                return {"features": list(enc_feats)}

        with span("idt.trunk.matching"):
            all_images = torch.cat([cur_image[:, None], src_image], dim=1)
            mfeats = self.matching(
                all_images.reshape((b * (k + 1),) + all_images.shape[2:]).to(cdt))
            mfeats = mfeats.permute(0, 2, 3, 1)                        # NHWC
            mfeats = mfeats.reshape((b, k + 1) + mfeats.shape[1:])
            if flip:
                mfeats = mfeats.flip(3)
            m_cur, m_src = mfeats[:, 0], mfeats[:, 1:]
            if stop_at == "matching":
                return {"features": [m_cur, m_src] + list(enc_feats)}

        with span("idt.trunk.volume"):
            planes = geometry.log_depth_planes(self.min_matching_depth, self.max_matching_depth,
                                               self.num_depth_bins, device=m_cur.device)
            s = self.matching_scale
            geo = (src_data[f"K_s{s}"].float(), src_T_cur, cur_data[f"invK_s{s}"].float(),
                   cur_T_src, planes)
            with no_autocast:                                          # (b, d, h, w) volume
                if self.feature_volume_type == "zero_cost_volume":
                    volume = cv.zero_cost_volume(b, self.num_depth_bins, m_cur.shape[1],
                                                 m_cur.shape[2], m_cur.dtype, m_cur.device)
                elif self.feature_volume_type == "simple_cost_volume":
                    volume = cv.dot_cost_volume(cv.build_warped_views(m_cur, m_src, *geo,
                                                                      compute_dtype=cdt))
                else:
                    volume_fn = self.volume_mlp.fused_train if train else self.volume_mlp.fused
                    volume = volume_fn(m_cur, m_src, *geo)             # f32
                lowest = cv.lowest_cost_depth(volume.detach(), planes)
            if stop_at == "volume" and self.feature_volume_type != "zero_cost_volume":
                return {"features": [volume] + list(enc_feats)}

        with span("idt.trunk.cv_encoder"):
            if flip:
                volume = volume.flip(3)
            cv_feats = self.cv_encoder(volume.to(cdt), enc_feats[s:])
            if stop_at == "cv_encoder":
                return {"features": cv_feats}

        with span("idt.trunk.decoder"):
            dec = self.decoder(list(enc_feats[:s]) + cv_feats)
            if flip:
                dec = {i: f.flip(3) for i, f in dec.items()}
        return {"features": dec, "lowest_cost": lowest, "depth_planes": planes}

    # ---------------- query heads ----------------
    def run_mlp_train(self, cur_data: dict, features: dict,
                      prior_noise: Optional[list] = None) -> dict:
        """Sparse ray queries at every scale: gt depth sampled bilinearly at
        the rays (sampled_rays (b, N, 2) in gt-depth pixels), rays and
        sample depths (b, N, S) taken every (s+1)-th at scale s, the
        decoder features sampled at them and fed to `factored`. With
        use_prior, prior_noise (draw_prior_noise) makes each scale's
        augmented prior in the features' dtype. Returns target_depth (b, N),
        query_depth (b, N, S), pred_s (b, N_s, S)."""
        if self.use_prior and prior_noise is None:
            raise ValueError("a net with use_prior trains on prior_noise (draw_prior_noise)")
        with span("idt.heads"):
            gt_depth = cur_data["gt_depth"]
            hg, wg = gt_depth.shape[1], gt_depth.shape[2]
            rays = cur_data["sampled_rays"]
            depths = cur_data["sampled_depths"]
            grid = torch.stack([(rays[..., 0] / wg - 0.5) * 2.0,
                                (rays[..., 1] / hg - 0.5) * 2.0], dim=-1)  # (b, N, 2)
            target = grid_sample(gt_depth, grid[:, :, None], mode="bilinear")[:, :, 0, 0]
            feats, sub_depths, priors = [], [], []
            for scale in SCALES:
                feat = features[scale].permute(0, 2, 3, 1)          # NHWC
                sub_grid = grid[:, :: scale + 1]
                feats.append(grid_sample(feat, sub_grid[:, :, None], mode="bilinear")[:, :, 0])
                sub_depths.append(depths[:, :: scale + 1])
                if self.use_prior:
                    u_offset, u_flip = (u.to(feats[-1].dtype) for u in prior_noise[scale])
                    priors.append(augment_prior(sub_depths[-1], target[:, :: scale + 1],
                                                u_offset, u_flip))
            out = {"target_depth": target, "query_depth": depths}
            out.update(self.binary_mlp.factored(feats, sub_depths,
                                                priors if self.use_prior else None))
            return out

    def sample_prior(self, rendered_depth: Tensor, prior_prediction: Tensor,
                     cam_to_world: Tensor, prior_world_to_cam: Tensor, K: Tensor,
                     invK: Tensor) -> Tensor:
        """The previous frame's prediction warped into this frame through
        the rendered depth: each pixel's rendered point, projected into the
        prior camera, samples prior_prediction (nearest); -1 where the
        rendered depth is <= 0 or the point lies behind the prior camera.
        rendered_depth, prior_prediction (b, h, w, 1) -> (b, h, w, 1) f32."""
        b, h, w = rendered_depth.shape[:3]
        with torch.autocast(rendered_depth.device.type, enabled=False):
            cur_to_prior = torch.einsum("bij,bjk->bik", prior_world_to_cam.float(),
                                        cam_to_world.float())
            pts = geometry.backproject_depth(rendered_depth[..., 0].float(), invK.float())
            cam = geometry.project_points(pts.reshape(b, -1, 4), K.float(), cur_to_prior)
            uv = cam[..., :2].reshape(b, h, w, 2)
            grid = torch.stack([(uv[..., 0] / w - 0.5) * 2, (uv[..., 1] / h - 0.5) * 2], -1)
            sampled = grid_sample(prior_prediction.float(), grid, mode="nearest")
            z = cam[..., 2].reshape(b, h, w, 1)
            valid = (rendered_depth > 0) & (z > 0)
            return torch.where(valid, sampled, torch.full_like(sampled, -1.0))

    def run_mlp_val(self, cur_data: dict, features: dict, rendered_depth: Tensor) -> Tensor:
        """Dense queries at scale 0. rendered_depth (b, h0, w0, 1) ->
        logits (b, h0, w0). With use_prior the prior is
        sample_prior(cur_data["rendered_depth_full"], ...) where
        cur_data["prior_prediction"] is given, else -1 everywhere."""
        feat = features[0].permute(0, 2, 3, 1)                        # (b, h0, w0, c)
        parts = [rendered_depth.to(feat.dtype), feat]
        if self.use_prior:
            if cur_data.get("prior_prediction") is not None:
                prior = self.sample_prior(
                    cur_data["rendered_depth_full"], cur_data["prior_prediction"],
                    cur_data["world_T_cam"], cur_data["prior_cam_T_world"],
                    cur_data["K_s0"], cur_data["invK_s0"])
            else:
                prior = torch.full_like(rendered_depth, -1.0)
            parts.append(prior.to(feat.dtype))
        return self.binary_mlp([torch.cat(parts, dim=-1)], max_scale_only=True)["pred_0"][..., 0]

    # ---------------- entry points ----------------
    def forward(self, cur_data: dict, src_data: dict, flip: bool = False,
                prior_noise: Optional[list] = None) -> dict:
        """Train forward: trunk with the differentiable volume + sparse ray
        queries (with use_prior, on the draws prior_noise). Returns
        target_depth, query_depth, pred_0..3, lowest_cost."""
        with span("idt.forward"):
            t = self.trunk(cur_data, src_data, flip, train=True)
            out = self.run_mlp_train(cur_data, t["features"], prior_noise)
            out["lowest_cost"] = t["lowest_cost"]
            return out

    def forward_val(self, cur_data: dict, src_data: dict) -> dict:
        """Dense queries for every rendered-depth channel:
        {"pred_0": (b, h0, w0, P) logits, "lowest_cost": (b, h, w)}. With
        use_prior, cur_data may hold prior_prediction (b, h0, w0, 1) and
        prior_cam_T_world (b, 4, 4); each channel warps the prior through
        its own rendered depth."""
        with span("idt.forward_val"):
            t = self.trunk(cur_data, src_data)
            rendered = cur_data["rendered_depth"]
            logits = []
            with span("idt.heads"):
                for i in range(rendered.shape[-1]):
                    q = rendered[..., i: i + 1]
                    logits.append(self.run_mlp_val(dict(cur_data, rendered_depth_full=q),
                                                   t["features"], q))
                pred = torch.stack(logits, dim=-1)
            return {"pred_0": pred, "lowest_cost": t["lowest_cost"]}

    def forward_infer_depth(self, cur_data: dict, src_data: dict,
                            threshold_bins: Optional[Tensor] = None,
                            threshold_values: Optional[Tensor] = None,
                            num_iters: int = 12) -> dict:
        """Depth from the binary oracle by bisection, as the JAX package's:
        the trunk once, then `num_iters` scale-0 head passes. Each pixel
        starts at lo 0.5, hi 8, mid 3.75; where sigmoid(m * logit) at mid
        is below the threshold (strictly) hi moves to mid, else lo does,
        and mid becomes (lo + hi) / 2. The threshold is
        0.5, or threshold_values at the bin of mid in threshold_bins (side
        left, the index clamped to the last bin as a JAX gather clamps).
        The carry stays f32 on the device: no host sync in the loop.
        Returns {"search_depths": (b, h0, w0) f32, "lowest_cost"}."""
        t = self.trunk(cur_data, src_data)
        shape = cur_data["rendered_depth"][..., :1].shape
        dev = t["lowest_cost"].device

        def threshold_for(depths: Tensor):
            if threshold_values is None:
                return 0.5
            idx = torch.searchsorted(threshold_bins, depths.contiguous(), right=False)
            return threshold_values[idx.clamp_max(threshold_values.shape[0] - 1)]

        lo = torch.full(shape, 0.5, device=dev)
        hi = torch.full(shape, 8.0, device=dev)
        mid = torch.full(shape, 7.5 / 2.0, device=dev)
        for _ in range(num_iters):
            logits = self.run_mlp_val(cur_data, t["features"], mid)
            pred = torch.sigmoid(self.bd_sigmoid_multiplier * logits)[..., None]
            visible = pred < threshold_for(mid)
            hi = torch.where(visible, mid, hi)
            lo = torch.where(visible, lo, mid)
            mid = (lo + hi) / 2.0
        return {"search_depths": mid[..., 0], "lowest_cost": t["lowest_cost"]}
