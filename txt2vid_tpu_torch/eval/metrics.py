"""Sample-fidelity metrics (counterpart of txt2vid_tpu/eval/metrics.py).

  * `frechet_distance` / `fid_from_features` - the Frechet distance between
    Gaussians fit to two feature sets, in float64 on the host (the port's
    copy of the JAX package's numpy code).
  * `RandomConvFeatures` - a fixed random 3-D conv pyramid, the cheap FID
    proxy; `discrim_features` - the trained discriminator's pooled features.
  * `sample_fidelity_report` - FID between real and generated video batches
    plus pixel statistics.

flax's Conv pads SAME: with stride 2 on an even size that is (0, 1), one
row and column after the input and none before; a symmetric padding=1
would sample windows shifted by a pixel. models/layers.SameConv3d pads as
flax does, here and in the classifier.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from txt2vid_tpu_torch import resolve_device
from txt2vid_tpu_torch.models.layers import SameConv3d
from txt2vid_tpu_torch.ops.initializers import lecun_normal_


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2*sqrt(S1 S2)), numpy (host-side)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2

    # sqrt(S1 S2) has the same trace as sqrt(sqrt(S1) S2 sqrt(S1)) (PSD)
    w1, v1 = np.linalg.eigh(sigma1 + eps * np.eye(len(sigma1)))
    sqrt_s1 = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T
    inner = sqrt_s1 @ sigma2 @ sqrt_s1
    w, _ = np.linalg.eigh(inner)
    tr_sqrt = np.sum(np.sqrt(np.clip(w, 0, None)))

    # numerical cancellation can leave a tiny negative for (near-)identical inputs
    return float(max(0.0, diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                     - 2.0 * tr_sqrt))


def fid_from_features(feats_real, feats_fake):
    """FID between two (N, D) feature sets."""
    fr = np.asarray(feats_real, np.float64)
    ff = np.asarray(feats_fake, np.float64)
    return frechet_distance(fr.mean(0), np.cov(fr, rowvar=False),
                            ff.mean(0), np.cov(ff, rowvar=False))


def load_flax_params(modules: dict, params: dict):
    """Copy a flax params tree {"Conv_0": {"kernel"}, "Dense_1": {"kernel",
    "bias"}, "GroupNorm_0": {"scale", "bias"}, ...} into the torch modules
    named by the same keys; every leaf must have its counterpart."""
    if sorted(modules) != sorted(params):
        raise KeyError(f"params {sorted(params)} for modules {sorted(modules)}")
    with torch.no_grad():
        for name, m in modules.items():
            leaves = dict(params[name])
            k = leaves.pop("kernel", leaves.pop("scale", None))
            k = torch.tensor(np.asarray(k, np.float32))
            if k.dim() == 5:                       # (kd, kh, kw, I, O)
                k = k.permute(4, 3, 0, 1, 2)
            elif k.dim() == 2:                     # (in, out)
                k = k.t()
            m.weight.copy_(k)
            if "bias" in leaves:
                m.bias.copy_(torch.tensor(np.asarray(leaves.pop("bias"), np.float32)))
            if leaves or (m.bias is not None and "bias" not in params[name]):
                raise KeyError(f"{name}: leaves {sorted(params[name])} for {m}")


class RandomConvFeatures(nn.Module):
    """Fixed random 3-D conv pyramid -> (B, feature_dim) for videos (B, T, H,
    W, C): three SAME convs (32, 64, 128 channels, stride (1, 2, 2), no
    bias) with ReLU, the mean over (T, H, W), a Dense without bias.

    The weights come from a torch.Generator seeded with `seed`, drawn with
    flax's default distribution (lecun-normal), not from jax.random: the
    port's fid_random_conv is port-relative, comparable between the port's
    runs but not with the JAX package's. Given the JAX package's params
    (`load_flax`) the two agree."""

    def __init__(self, in_channels: int, feature_dim: int = 256, seed: int = 0):
        super().__init__()
        chans = (in_channels, 32, 64, 128)
        self.convs = nn.ModuleList(
            SameConv3d(a, b, 3, stride=(1, 2, 2), bias=False) for a, b in zip(chans, chans[1:]))
        self.dense = nn.Linear(128, feature_dim, bias=False)
        gen = torch.Generator().manual_seed(seed)
        for m in (*self.convs, self.dense):
            lecun_normal_(m.weight, generator=gen)

    def load_flax(self, params):
        """The JAX package's variables {"params": {"Conv_0", ..., "Dense_0"}}."""
        load_flax_params({**{f"Conv_{i}": c for i, c in enumerate(self.convs)},
                          "Dense_0": self.dense}, params["params"])
        return self

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.dense(x.mean(dim=(2, 3, 4)))


@torch.no_grad()
def batched_apply(fn, videos, batch_size, device):
    """fn over (N, ...) host videos in chunks of batch_size on `device`; the
    outputs concatenated on the host."""
    out = []
    for i in range(0, len(videos), batch_size):
        v = torch.as_tensor(np.asarray(videos[i:i + batch_size]), dtype=torch.float32)
        out.append(fn(v.to(device)).cpu().numpy())
    return np.concatenate(out)


def extract_features(videos, model=None, batch_size: int = 32, device=None):
    """Run the feature extractor over a (N, T, H, W, C) array in chunks on
    `device` (default CUDA); -> (features (N, D), model)."""
    device = resolve_device(device)
    model = (model or RandomConvFeatures(np.shape(videos)[-1])).to(device).eval()
    return batched_apply(model, videos, batch_size, device), model


def discrim_features(gan, videos, batch_size: int = 32):
    """(N, T, H, W, C) -> (N, D) features of the trained discriminator 0 (its
    first scale's pooled features, the input of its heads) on the device it
    lives on. Its Attention3d runs the fused attention forward (K1)."""
    d = gan.discrims[0]
    if not getattr(d, "is_multiscale", False):
        raise ValueError(f"discriminator 0 ({type(d).__name__}) gives no features for the "
                         "discriminator FID: evaluate with --no_discrim_fid")
    device = next(d.parameters()).device
    return batched_apply(lambda v: gan.apply_discrim(0, [v])[0][2], videos, batch_size, device)


def sample_fidelity_report(real_videos, fake_videos, batch_size: int = 32,
                           feature_fn=None, device=None):
    """FID over random-conv features (+ the FID over `feature_fn`'s features
    where given) and pixel statistics of two video sets."""
    fr, model = extract_features(real_videos, batch_size=batch_size, device=device)
    ff, _ = extract_features(fake_videos, model=model, batch_size=batch_size, device=device)
    real = np.asarray(real_videos, np.float32)
    fake = np.asarray(fake_videos, np.float32)
    report = {
        "fid_random_conv": fid_from_features(fr, ff),
        "real_mean": float(real.mean()), "fake_mean": float(fake.mean()),
        "real_std": float(real.std()), "fake_std": float(fake.std()),
    }
    if feature_fn is not None:
        report["fid_discrim"] = fid_from_features(feature_fn(real_videos),
                                                  feature_fn(fake_videos))
    return report
