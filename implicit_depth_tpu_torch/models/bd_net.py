"""BDNet — the implicit binary-depth model, dense eval forward (torch).

Counterpart of implicit_depth_tpu/models/bd_net.py for the path that
`forward_val` runs: image encoder (EfficientNetV2-S or the tiny test
encoder), the ResNet matching encoder on all views, the metadata feature
volume through ops/fused_volume.py (the CUDA kernel on CUDA tensors, its
plain version on CPU tensors), CVEncoder -> DecoderPP, and the scale-0
query head once per rendered-depth plane. Training, the prior, the flip
path, the zero/dot volumes, the FPN matching encoder, the skip decoder and
depth-by-bisection are not ported yet (train/loop.py::build_net refuses
configs that need them).

Batch dicts use the JAX package's NHWC layout (see its module docstring);
the conv stacks run in NCHW. Pose products are f32 at full precision.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from implicit_depth_tpu_torch.core import geometry
from implicit_depth_tpu_torch.models.decoders import NUM_CH_DEC, BinaryMLPNetwork, CVEncoder, DecoderPP
from implicit_depth_tpu_torch.models.image_encoders import EfficientNetV2S, TinyEncoder
from implicit_depth_tpu_torch.models.matching import ResnetMatchingEncoder
from implicit_depth_tpu_torch.models.volume_mlp import MetadataVolumeMLP
from implicit_depth_tpu_torch.volumes import cost_volume as cv

Tensor = torch.Tensor

SCALES = (0, 1, 2, 3)
# query heads only the training forward runs; an eval-initialised flax tree
# does not hold them
TRAIN_ONLY_PREFIXES = tuple(f"binary_mlp.s{s}_" for s in SCALES[1:])


class BDNet(nn.Module):
    def __init__(
        self,
        image_encoder_name: str = "efficientnet",
        matching_scale: int = 1,
        matching_feature_dims: int = 16,
        num_depth_bins: int = 64,
        num_src_views: int = 7,
        min_matching_depth: float = 0.25,
        max_matching_depth: float = 5.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.matching_scale = matching_scale
        self.num_depth_bins = num_depth_bins
        self.min_matching_depth = min_matching_depth
        self.max_matching_depth = max_matching_depth
        self.compute_dtype = compute_dtype

        if "efficientnet" in image_encoder_name:
            self.encoder = EfficientNetV2S()
        elif "tiny" in image_encoder_name:
            self.encoder = TinyEncoder()
        else:
            raise NotImplementedError(f"image encoder {image_encoder_name} is not ported")
        enc_ch = list(self.encoder.num_ch_enc)
        self.matching = ResnetMatchingEncoder(num_ch_out=matching_feature_dims)
        self.volume_mlp = MetadataVolumeMLP(num_src_views=num_src_views,
                                            matching_dim=matching_feature_dims)
        self.cv_encoder = CVEncoder(num_depth_bins, enc_ch[matching_scale:])
        self.decoder = DecoderPP(enc_ch[:matching_scale] + list(self.cv_encoder.num_ch_outs))
        self.binary_mlp = BinaryMLPNetwork([NUM_CH_DEC[s] + 1 for s in SCALES])

    def cast_to_compute_dtype(self) -> "BDNet":
        """Casts the conv and dense stacks to the compute dtype. The volume
        MLP stays f32: its kernel takes f32 operands besides the features."""
        for name in ("encoder", "matching", "cv_encoder", "decoder", "binary_mlp"):
            getattr(self, name).to(self.compute_dtype)
        return self

    # ---------------- shared trunk ----------------
    def trunk(self, cur_data: dict, src_data: dict) -> dict:
        """Encoders + cost volume + U-Net. Returns per-scale decoder features
        (NCHW) and the lowest-cost depth."""
        cdt = self.compute_dtype
        cur_image = cur_data["image"].permute(0, 3, 1, 2)             # (b, 3, h, w)
        src_image = src_data["image"].permute(0, 1, 4, 2, 3)          # (b, k, 3, h, w)
        b, k = src_image.shape[:2]

        src_T_cur = torch.einsum("bkij,bjl->bkil", src_data["cam_T_world"].float(),
                                 cur_data["world_T_cam"].float())
        cur_T_src = torch.einsum("bij,bkjl->bkil", cur_data["cam_T_world"].float(),
                                 src_data["world_T_cam"].float())

        enc_feats = self.encoder(cur_image.to(cdt))

        all_images = torch.cat([cur_image[:, None], src_image], dim=1)
        mfeats = self.matching(all_images.reshape((b * (k + 1),) + all_images.shape[2:]).to(cdt))
        mfeats = mfeats.permute(0, 2, 3, 1)                            # NHWC
        mfeats = mfeats.reshape((b, k + 1) + mfeats.shape[1:])
        m_cur, m_src = mfeats[:, 0], mfeats[:, 1:]

        planes = geometry.log_depth_planes(self.min_matching_depth, self.max_matching_depth,
                                           self.num_depth_bins, device=m_cur.device)
        s = self.matching_scale
        volume = self.volume_mlp.fused(
            m_cur, m_src, src_data[f"K_s{s}"].float(), src_T_cur,
            cur_data[f"invK_s{s}"].float(), cur_T_src, planes)       # (b, d, h, w) f32
        lowest = cv.lowest_cost_depth(volume, planes)

        cv_feats = self.cv_encoder(volume.to(cdt), enc_feats[s:])
        dec = self.decoder(list(enc_feats[:s]) + cv_feats)
        return {"features": dec, "lowest_cost": lowest}

    # ---------------- query head ----------------
    def run_mlp_val(self, cur_data: dict, features: dict, rendered_depth: Tensor) -> Tensor:
        """Dense queries at scale 0. rendered_depth (b, h0, w0, 1) ->
        logits (b, h0, w0)."""
        feat = features[0].permute(0, 2, 3, 1)                        # (b, h0, w0, c)
        x = torch.cat([rendered_depth.to(feat.dtype), feat], dim=-1)
        return self.binary_mlp([x], max_scale_only=True)["pred_0"][..., 0]

    # ---------------- entry point ----------------
    def forward_val(self, cur_data: dict, src_data: dict) -> dict:
        """Dense queries for every rendered-depth channel:
        {"pred_0": (b, h0, w0, P) logits, "lowest_cost": (b, h, w)}."""
        t = self.trunk(cur_data, src_data)
        rendered = cur_data["rendered_depth"]
        logits = [self.run_mlp_val(cur_data, t["features"], rendered[..., i: i + 1])
                  for i in range(rendered.shape[-1])]
        return {"pred_0": torch.stack(logits, dim=-1), "lowest_cost": t["lowest_cost"]}
