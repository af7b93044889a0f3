"""What the encoder zoo adds to a BD train step's device memory, reckoned on
the CPU: for each image encoder, matching encoder and decoder, the bytes of
the tensors autograd keeps for the backward of one training forward (bf16
autocast, batch norm in train mode; each storage counted once), measured at
64x96 and scaled by pixels and batch to the step's shapes (b=12 at 512x384,
the matching encoder on b x 8 views), and the bytes of its parameters with
their gradients and AdamW's two moments (16 bytes a parameter) and the bf16
copies autocast keeps (2 bytes). Then the aten operations that one
`forward_val` of each BD model dispatches (K=7, D=64, 8 query planes, bf16,
on the CPU at 64x96): the eval forward is host-bound on the card, and its
host time follows its launches. A prediction for the card, not a
measurement of it: the CPU's autocast keeps other casts than CUDA's, and
the backward's own temporaries are not counted.

    python -m implicit_depth_tpu_torch.tools.saved_activations [--batch 12]
"""

from __future__ import annotations

import argparse

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from implicit_depth_tpu_torch.models.bd_net import BDNet
from implicit_depth_tpu_torch.models.decoders import DecoderPP, SkipDecoder
from implicit_depth_tpu_torch.models.depth_net import image_encoder, matching_encoder
from implicit_depth_tpu_torch.utils.fixtures import synthetic_bd_batch
from implicit_depth_tpu_torch.weights import init_params

H, W = 64, 96
SCALE = (384 * 512) / (H * W)  # pixels of a 512x384 image over the measured size
VIEWS = 8
CV_CHANNELS = (64, 128, 256, 384)  # the CV encoder's outputs, strides 4 to 32


def saved_bytes(module: torch.nn.Module, inputs) -> int:
    """Bytes of the distinct storages autograd saves in module(inputs)."""
    seen: dict = {}

    def pack(t: torch.Tensor):
        storage = t.untyped_storage()
        seen[storage.data_ptr()] = storage.nbytes()
        return t

    module.train()
    with torch.autocast("cpu", dtype=torch.bfloat16), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        module(inputs)
    return sum(seen.values())


def param_bytes(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters()) * (16 + 2)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def forward_val_ops(**parts) -> int:
    """The aten operations of one bf16 forward_val of the flagship-width
    BDNet with `parts` (K=7, D=64, 8 query planes, 64x96)."""
    net = BDNet(num_src_views=7, num_depth_bins=64, compute_dtype=torch.bfloat16, **parts)
    net = init_params(net, torch.Generator().manual_seed(0)).eval().cast_to_compute_dtype()
    cur, src = (dict((k, torch.tensor(v)) for k, v in d.items()) for d in synthetic_bd_batch(
        batch=1, num_src=7, height=H, width=W, num_planes=8, with_train_keys=False))
    with torch.inference_mode(), _CountOps() as counter:
        net.forward_val(cur, src)
    return counter.count


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    b = ap.parse_args(argv).batch
    gib = 2.0 ** 30
    image = torch.randn(1, 3, H, W)
    rows = []
    for name in ("efficientnet", "resnet18d", "resnext101_64x4d", "seresnextaa101d_32x8d"):
        enc = image_encoder(name)
        rows.append((f"image encoder {name}", saved_bytes(enc, image) * SCALE * b,
                     param_bytes(enc)))
        feats = [torch.randn(1, c, H >> (i + 1), W >> (i + 1))
                 for i, c in enumerate((enc.num_ch_enc[0],) + CV_CHANNELS)]
        for dec_name, dec in (("unet_pp", DecoderPP([f.shape[1] for f in feats])),
                              ("skip", SkipDecoder([f.shape[1] for f in feats]))):
            rows.append((f"  decoder {dec_name} after it", saved_bytes(dec, feats) * SCALE * b,
                         param_bytes(dec)))
    for kind in ("resnet", "fpn"):
        m = matching_encoder(kind, 16)
        rows.append((f"matching encoder {kind} ({VIEWS} views)",
                     saved_bytes(m, image) * SCALE * b * VIEWS, param_bytes(m)))
    print(f"b={b}, 512x384, bf16 autocast, train-mode batch norm (scaled from {H}x{W}):")
    for label, act, par in rows:
        print(f"{label:48s} saved for backward {act / gib:7.2f} GiB, parameters + grads + "
              f"AdamW + bf16 copies {par / gib:6.3f} GiB")
    for label, parts in (("flagship", {}),
                         ("(a) resnet18d, fpn, skip", dict(image_encoder_name="resnet18d",
                                                           matching_encoder_type="fpn",
                                                           depth_decoder_name="skip")),
                         ("(b) resnext101_64x4d", dict(image_encoder_name="resnext101_64x4d")),
                         ("(c) seresnextaa101d_32x8d",
                          dict(image_encoder_name="seresnextaa101d_32x8d"))):
        print(f"forward_val of BDNet {label:32s} {forward_val_ops(**parts):6d} aten operations")


if __name__ == "__main__":
    main()
