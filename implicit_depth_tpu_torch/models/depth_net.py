"""DepthNet — the SimpleRecon-style depth regression model (torch).

Counterpart of implicit_depth_tpu/models/depth_net.py: the trunk of BDNet
(image encoder, matching encoder on all views, a cost volume over the plane
sweep, CVEncoder, decoder), decoding straight to log-depth maps at four
scales through DecoderPP's 1x1 heads or SkipDecoder's regression heads.
The parts are chosen by name as in the JAX package, which BDNet shares
(`image_encoder`, `matching_encoder`, `depth_decoder`):
- image encoder, by substring in this order: `efficientnet`
  (EfficientNetV2-S), `tiny`, `resnext101` (ResNeXt101-64x4d),
  `seresnextaa101d` (SE-ResNeXt-AA101d-32x8d), then `resnet` (ResNet18-D);
  any other name is a ValueError;
- matching encoder: `fpn` (MNASNet + FPN), any other the ResNet one;
- decoder: `unet_pp` (DecoderPP) or `skip` (SkipDecoder), else ValueError.
Ported volumes:
- `mlp_feature_volume`: the metadata MLP run unfused over the warped views
  (MetadataVolumeMLP.forward), as the JAX DepthNet does;
- `simple_cost_volume`: the dot-product volume summed over views;
- `zero_cost_volume`: the ablation volume of zeros.
The warp is volumes/cost_volume.py::build_warped_views, i.e. kernels #5
(forward) and #6 (backward) of ops/warp_kernel.py on CUDA tensors.

Flip augmentation follows the JAX package: images flipped, matching features
unflipped before the volume, the volume re-flipped before the CV encoder,
log depths unflipped at the end. `lowest_cost` comes from the detached
volume.

Batch dicts use the JAX package's NHWC layout; the conv stacks run on
NCHW-shaped tensors, channels_last at half precision, as BDNet's do.
Pose products and the warp geometry are f32 at full precision, also under
autocast; the warped features and the volume take the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from implicit_depth_tpu_torch.core import geometry
from implicit_depth_tpu_torch.models.blocks import conv_memory_format, stack_input
from implicit_depth_tpu_torch.models.decoders import CVEncoder, DecoderPP, SkipDecoder
from implicit_depth_tpu_torch.models.fpn_matching import FPNMatchingEncoder
from implicit_depth_tpu_torch.models.image_encoders import EfficientNetV2S, ResNet18D, TinyEncoder
from implicit_depth_tpu_torch.models.matching import ResnetMatchingEncoder
from implicit_depth_tpu_torch.models.resnets import ResNeXt101_64x4d, SEResNeXtAA101d_32x8d
from implicit_depth_tpu_torch.models.volume_mlp import MetadataVolumeMLP
from implicit_depth_tpu_torch.utils.profiling import span
from implicit_depth_tpu_torch.volumes import cost_volume as cv

Tensor = torch.Tensor

SCALES = (0, 1, 2, 3)
VOLUME_TYPES = ("mlp_feature_volume", "simple_cost_volume", "zero_cost_volume")


def image_encoder(name: str) -> nn.Module:
    """The image encoder a name selects, tested in the JAX package's order
    (so "seresnextaa101d_32x8d" is not taken for "resnet")."""
    if "efficientnet" in name:
        return EfficientNetV2S()
    if "tiny" in name:
        return TinyEncoder()
    if "resnext101" in name:
        return ResNeXt101_64x4d()
    if "seresnextaa101d" in name:
        return SEResNeXtAA101d_32x8d()
    if "resnet" in name:
        return ResNet18D()
    raise ValueError(f"Unknown image encoder {name}")


def matching_encoder(matching_encoder_type: str, num_ch_out: int) -> nn.Module:
    if matching_encoder_type == "fpn":
        return FPNMatchingEncoder(num_ch_out=num_ch_out)
    return ResnetMatchingEncoder(num_ch_out=num_ch_out)


def depth_decoder(name: str, enc_channels: list, regression: bool) -> nn.Module:
    """DecoderPP or SkipDecoder over features of `enc_channels`; with
    `regression` the log-depth heads (DecoderPP's 1x1 heads, SkipDecoder's
    regression heads)."""
    if name == "unet_pp":
        return DecoderPP(enc_channels, head_channels=int(regression))
    if name == "skip":
        return SkipDecoder(enc_channels, regression_heads=regression)
    raise ValueError(f"Unknown decoder {name}")


class DepthNet(nn.Module):
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
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if feature_volume_type not in VOLUME_TYPES:
            raise NotImplementedError(f"feature volume {feature_volume_type} is not ported")
        self.feature_volume_type = feature_volume_type
        self.depth_decoder_name = depth_decoder_name
        self.matching_scale = matching_scale
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
                                     regression=True)
        self.to(memory_format=conv_memory_format(compute_dtype))  # the conv weights: all 4-D

    def cast_to_compute_dtype(self) -> "DepthNet":
        """Casts the conv stacks to the compute dtype for inference. The
        volume MLP keeps f32 parameters: it casts them to the features'
        dtype itself."""
        for name in ("encoder", "matching", "cv_encoder", "decoder"):
            getattr(self, name).to(self.compute_dtype)
        return self

    def forward(self, cur_data: dict, src_data: dict, flip: bool = False) -> dict:
        """{"lowest_cost": (b, h, w), "log_depth_pred_s" and "depth_pred_s":
        (b, h_s, w_s, 1) f32 for s = 0..3}.

        Runs in the span idt.forward, each stage in its trunk span as
        BDNet.trunk's (utils/profiling.py::SPANS), and the warp (#5) in
        idt.trunk.warp inside idt.trunk.volume."""
        with span("idt.forward"):
            return self._forward(cur_data, src_data, flip)

    def _forward(self, cur_data: dict, src_data: dict, flip: bool) -> dict:
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

            enc_feats = self.encoder(stack_input(cur_image, cdt))

        with span("idt.trunk.matching"):
            all_images = torch.cat([cur_image[:, None], src_image], dim=1)
            mfeats = self.matching(
                stack_input(all_images.reshape((b * (k + 1),) + all_images.shape[2:]), cdt))
            mfeats = mfeats.permute(0, 2, 3, 1)                        # NHWC
            mfeats = mfeats.reshape((b, k + 1) + mfeats.shape[1:])
            if flip:
                mfeats = mfeats.flip(3)
            m_cur, m_src = mfeats[:, 0], mfeats[:, 1:]

        with span("idt.trunk.volume"):
            planes = geometry.log_depth_planes(self.min_matching_depth, self.max_matching_depth,
                                               self.num_depth_bins, device=m_cur.device)
            s = self.matching_scale
            with no_autocast:
                if self.feature_volume_type == "zero_cost_volume":
                    h, w = m_cur.shape[1], m_cur.shape[2]
                    volume = cv.zero_cost_volume(b, self.num_depth_bins, h, w, m_cur.dtype,
                                                 m_cur.device)
                else:
                    with span("idt.trunk.warp"):
                        wv = cv.build_warped_views(
                            m_cur, m_src, src_data[f"K_s{s}"].float(), src_T_cur,
                            cur_data[f"invK_s{s}"].float(), cur_T_src, planes,
                            compute_dtype=cdt)
                    if self.feature_volume_type == "mlp_feature_volume":
                        volume = self.volume_mlp(wv, m_cur)
                    else:
                        volume = cv.dot_cost_volume(wv)
                lowest = cv.lowest_cost_depth(volume.detach(), planes)  # (b, d, h, w) volume

        with span("idt.trunk.cv_encoder"):
            if flip:
                volume = volume.flip(3)
            cv_feats = self.cv_encoder(stack_input(volume, cdt), enc_feats[s:])

        with span("idt.trunk.decoder"):
            dec = self.decoder(list(enc_feats[:s]) + cv_feats)
            outputs: dict = {"lowest_cost": lowest}
            for scale in SCALES:
                log_depth = dec[scale] if self.depth_decoder_name == "unet_pp" else \
                    dec[f"log_depth_{scale}"]
                log_depth = log_depth.float().permute(0, 2, 3, 1)     # (b, h_s, w_s, 1)
                if flip:
                    log_depth = log_depth.flip(2)
                outputs[f"log_depth_pred_{scale}"] = log_depth
                outputs[f"depth_pred_{scale}"] = torch.exp(log_depth)
            return outputs
