"""Frozen video classifier: a run-comparable fidelity metric for the synthetic
moving-digit data (counterpart of txt2vid_tpu/eval/classifier.py).

A small 3-D conv classifier trained once on the captions' labels ("digit D
is M." -> digit D, motion M) and frozen in the repo gives
  * `classifier_features` - a fixed feature space in which any two runs or
    checkpoints are comparable (`classifier_fid`, the `fid_cls` of RESULTS.md),
  * label heads whose accuracy on generated samples is a second capability
    signal (`classify_videos`).

The port reads its own byte-for-byte copy of the JAX package's float16 flax
msgpack (weights/video_cls.msgpack) with utils/msgpack.py.

Every input is canonicalized to (16, 32, 32, 1) inside forward: RGB is
averaged to luma, and jax.image.resize(..., "linear") resamples, which
antialiases when it shrinks (a triangle kernel widened by the shrink
factor). torch's interpolate cannot do that in 3-D, so `resize_linear`
builds JAX's weight matrix per axis and applies it separably: 16x64x64
(64-px runs) -> 16x32x32, 32x128x128 (cond-128 runs) -> 16x32x32. The convs
pad as flax's SAME does; GroupNorm is flax's (eps 1e-6, variance
E[x^2] - E[x]^2).

Train (on the card unless --device cpu):
    python -m txt2vid_tpu_torch.eval.classifier --data train/videos.t2vc \\
        --anno train/sent.pickle --val_videos test/videos --val_anno test/sent.pickle \\
        --out video_cls.msgpack
"""

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from txt2vid_tpu_torch import resolve_device
from txt2vid_tpu_torch.data.synthetic import MOTION_CLASSES
from txt2vid_tpu_torch.eval.metrics import batched_apply, fid_from_features, load_flax_params
from txt2vid_tpu_torch.models.layers import SameConv3d
from txt2vid_tpu_torch.ops.initializers import init_from_seed, lecun_normal_
from txt2vid_tpu_torch.utils import msgpack

CANON_FRAMES = 16
CANON_SIZE = 32
FROZEN_PATH = Path(__file__).parent / "weights" / "video_cls.msgpack"

_CAP_RE = re.compile(r"digit\s+(\d)\s+is\s+(.+?)\.?\s*$")


def caption_labels(caption: str):
    """caption 'digit D is M.' -> (digit 0-9, motion 0-3) or None if unparseable."""
    m = _CAP_RE.match(caption.strip().lower())
    if not m:
        return None
    motion = m.group(2).strip()
    if motion not in MOTION_CLASSES:
        return None
    return int(m.group(1)), MOTION_CLASSES.index(motion)


def resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """jax.image's linear (triangle-kernel) resampling weights, antialiased,
    as an (in_size, out_size) float32 matrix, computed as JAX computes them
    (compute_weight_mat, in float32)."""
    inv = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = (1.0 - x / kernel_scale).clamp(min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x, shape):
    """(B, T, H, W, C) -> (B, *shape, C) as jax.image.resize(..., "linear")
    resamples: each axis whose size changes through its weight matrix."""
    for axis, n in zip((1, 2, 3), shape):
        if x.shape[axis] != n:
            w = resize_weights(x.shape[axis], n).to(x.device, x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([axis], [0])), -1, axis)
    return x


class GroupNorm(nn.Module):
    """flax's GroupNorm over (N, C, ...): statistics per sample and group of
    C / num_groups consecutive channels, the variance as E[x^2] - E[x]^2
    (floored at 0), (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        n, c = x.shape[:2]
        g = x.reshape(n, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = torch.clamp((g * g).mean(-1, keepdim=True) - mean * mean, min=0.0)
        shape = (n, c) + (1,) * (x.dim() - 2)

        def per_channel(t):                   # (n, groups, 1) -> (n, c, 1, ...)
            return t.repeat_interleave(c // self.num_groups, 1).reshape(shape)

        mul = per_channel(torch.rsqrt(var + self.eps)) * self.weight.view(shape[1:])
        return (x - per_channel(mean)) * mul + self.bias.view(shape[1:])


class VideoClassifier(nn.Module):
    """(B, T, H, W, C) in [-1, 1] -> (features (B, 128), digit logits (B, 10),
    motion logits (B, 4)); any T, H, W, C (canonicalized inside)."""

    STAGES = ((16, (1, 2, 2)), (32, (2, 2, 2)), (64, (2, 2, 2)), (128, (2, 2, 2)))

    def __init__(self):
        super().__init__()
        chans = (1,) + tuple(c for c, _ in self.STAGES)
        self.convs = nn.ModuleList(SameConv3d(a, b, 3, stride=s, bias=False)
                                   for a, (b, s) in zip(chans, self.STAGES))
        self.norms = nn.ModuleList(GroupNorm(8, c) for c, _ in self.STAGES)
        self.digit = nn.Linear(128, 10)
        self.motion = nn.Linear(128, 4)

    def init_weights(self, generator):
        """flax's defaults: lecun-normal kernels, zero biases, unit scales."""
        for m in (*self.convs, self.digit, self.motion):
            lecun_normal_(m.weight, generator=generator)
        for m in (self.digit, self.motion):
            nn.init.zeros_(m.bias)

    def flax_modules(self):
        return {**{f"Conv_{i}": c for i, c in enumerate(self.convs)},
                **{f"GroupNorm_{i}": n for i, n in enumerate(self.norms)},
                "Dense_0": self.digit, "Dense_1": self.motion}

    def load_flax(self, params):
        """Variables {"params": {...}} as the JAX classifier holds them."""
        load_flax_params(self.flax_modules(), params["params"])
        return self

    def flax_params(self):
        """The inverse of load_flax: {"params": tree} with numpy leaves (copies,
        not views of the parameters)."""
        tree = {}
        for name, m in self.flax_modules().items():
            w, b = (None if t is None else t.detach().cpu().clone() for t in (m.weight, m.bias))
            if w.dim() == 5:
                tree[name] = {"kernel": w.permute(2, 3, 4, 1, 0).numpy()}
            elif w.dim() == 2:
                tree[name] = {"kernel": w.t().numpy(), "bias": b.numpy()}
            else:
                tree[name] = {"bias": b.numpy(), "scale": w.numpy()}
        return {"params": {k: tree[k] for k in sorted(tree)}}

    @staticmethod
    def canonicalize(x):
        if x.shape[-1] != 1:                 # luma for RGB inputs
            x = x.mean(-1, keepdim=True)
        return resize_linear(x, (CANON_FRAMES, CANON_SIZE, CANON_SIZE))

    def forward(self, x):
        x = self.canonicalize(x).permute(0, 4, 1, 2, 3)
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        feats = x.mean(dim=(2, 3, 4))
        return feats, self.digit(feats), self.motion(feats)


def load_frozen(path=None, device=None):
    """The frozen classifier (float16 on disk -> float32) on `device`
    (default CUDA), or None where the file is absent."""
    p = Path(path) if path is not None else FROZEN_PATH
    if not p.exists():
        return None
    tree = msgpack.unpackb(p.read_bytes())
    params = {k: {n: msgpack.as_float32(a) for n, a in v.items()}
              for k, v in tree["params"].items()}
    return VideoClassifier().load_flax({"params": params}).to(resolve_device(device)).eval()


def _model(model, device):
    model = model if model is not None else load_frozen(device=device)
    if model is None:
        raise FileNotFoundError(f"no frozen classifier weights at {FROZEN_PATH}; train "
                                "with python -m txt2vid_tpu_torch.eval.classifier")
    return model


def _device(model):
    return next(model.parameters()).device


def classifier_features(videos, model=None, batch_size: int = 32, device=None):
    """(N, T, H, W, C) videos in [-1, 1] -> (N, 128) frozen-classifier features."""
    model = _model(model, device)
    return batched_apply(lambda v: model(v)[0], videos, batch_size, _device(model))


def classifier_fid(real_videos, fake_videos, model=None, batch_size: int = 32, device=None):
    """FID in the frozen classifier's feature space (run- and config-comparable)."""
    model = _model(model, device)
    return fid_from_features(classifier_features(real_videos, model, batch_size),
                             classifier_features(fake_videos, model, batch_size))


def classify_videos(videos, model=None, batch_size: int = 32, device=None):
    """-> (digit_pred (N,), motion_pred (N,)) from the frozen heads."""
    model = _model(model, device)
    preds = batched_apply(lambda v: torch.stack([h.argmax(-1) for h in model(v)[1:]], 1),
                          videos, batch_size, _device(model))
    return preds[:, 0], preds[:, 1]


# ---------------------------------------------------------------- training CLI


def _load_labelled(packed_path, anno):
    """Packed cache + caption pickle -> (dataset, kept indices, labels (N, 2));
    items whose caption does not parse are dropped."""
    from txt2vid_tpu_torch.data.packed import PackedVideoDataset

    ds = PackedVideoDataset(packed_path, vocab=None, captions=anno,
                            num_frames=CANON_FRAMES, frame_size=None,
                            num_channels=1, random_frames=1)
    keep, labels = [], []
    for i, cap in enumerate(ds.captions):
        lab = caption_labels(cap)
        if lab is not None:
            keep.append(i)
            labels.append(lab)
    return ds, np.asarray(keep), np.asarray(labels, np.int64)


def _load_val(video_dir, anno, n=500):
    from txt2vid_tpu_torch.data import load_pickle, load_video_frames

    sents = load_pickle(anno)
    vids, labels = [], []
    for vid, caps in list(sents.items())[:n]:
        lab = caption_labels(caps[0])
        if lab is None:
            continue
        vids.append(load_video_frames(Path(video_dir) / str(vid),
                                      num_frames=CANON_FRAMES, num_channels=1))
        labels.append(lab)
    return np.stack(vids), np.asarray(labels, np.int64)


def train_step(model, opt, video, lab):
    """One Adam step on the summed digit and motion cross-entropies;
    lab (B, 2) holds (digit, motion). Returns (loss, digit and motion logits)."""
    _, dl, ml = model(video)
    loss = F.cross_entropy(dl, lab[:, 0]) + F.cross_entropy(ml, lab[:, 1])
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss, dl, ml


def main(args):
    from txt2vid_tpu_torch.train.setup import setup
    from txt2vid_tpu_torch.utils import status

    seed, device = setup(args)
    ds, keep, labels = _load_labelled(args.data, args.anno)
    status(f"{len(keep)} labelled clips ({len(ds.captions) - len(keep)} unparseable dropped)")

    model = init_from_seed(VideoClassifier(), seed).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed)
    for step in range(args.steps):
        idx = rng.choice(len(keep), args.batch_size, replace=False)
        video = torch.as_tensor(ds.get_batch(keep[idx])["video"], dtype=torch.float32)
        lab = torch.as_tensor(labels[idx], device=device)
        loss, dl, ml = train_step(model, opt, video.to(device), lab)
        if step % 100 == 0 or step == args.steps - 1:
            acc_d = float((dl.argmax(-1) == lab[:, 0]).float().mean())
            acc_m = float((ml.argmax(-1) == lab[:, 1]).float().mean())
            status(f"step {step}: loss {float(loss.detach()):.4f} digit {acc_d:.3f} "
                   f"motion {acc_m:.3f}")

    model.eval()
    report = {"steps": args.steps}
    if args.val_videos:
        vv, vl = _load_val(args.val_videos, args.val_anno, n=args.val_n)
        dp, mp = classify_videos(vv, model)
        report["val_digit_acc"] = float((dp == vl[:, 0]).mean())
        report["val_motion_acc"] = float((mp == vl[:, 1]).mean())
        status(f"val: digit {report['val_digit_acc']:.4f} "
               f"motion {report['val_motion_acc']:.4f} (n={len(vl)})")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tree = model.flax_params()
    tree = {"params": {k: {n: a.astype(np.float16) for n, a in v.items()}
                       for k, v in tree["params"].items()}}
    out.write_bytes(msgpack.packb(tree))
    status(f"wrote {out} ({out.stat().st_size / 1e6:.2f} MB)")
    print(json.dumps(report))
    return report


def build_parser():
    p = argparse.ArgumentParser(description="Train the video classifier of fid_cls.")
    p.add_argument("--data", required=True, help="packed .t2vc cache")
    p.add_argument("--anno", required=True, help="caption pickle")
    p.add_argument("--val_videos", default=None)
    p.add_argument("--val_anno", default=None)
    p.add_argument("--val_n", type=int, default=500)
    p.add_argument("--out", default=str(FROZEN_PATH))
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
