"""Sample-fidelity evaluation CLI (counterpart of txt2vid_tpu/eval/run.py):
generate videos from a checkpoint and score them against real clips - FID
over random-conv features, over the trained discriminator's features
(unless --no_discrim_fid), pixel statistics, and `fid_cls`, the FID in the
frozen classifier's feature space (eval/classifier.py), when its weights are
present.

    python -m txt2vid_tpu_torch.eval.run --weights out/iter_... \\
        --G G.json --D D.json --sent txt2vid_tpu.models.txt.Seq2Seq \\
        --vocab vocab.pickle --data ./videos --anno sent.pickle --num 128 \\
        [--no_discrim_fid] [--device cpu]

--data is a directory of `<vid>.npy` clips or a dataset spec (JSON, e.g.
txt2vid_tpu.data.packed.packed_dataset). The real clips are a seeded
permutation's first --num, in whole batches; each batch's captions (cut to
16 tokens) condition its fakes, whose z comes from gan/trainer.sample.
"""

import argparse
import json

import numpy as np
import torch

from txt2vid_tpu_torch.config import create_object
from txt2vid_tpu_torch.data import VideoDataset, load_pickle, pad_captions
from txt2vid_tpu_torch.eval.metrics import discrim_features, sample_fidelity_report


def main(args):
    """Prints the report as one JSON line and returns it."""
    from txt2vid_tpu_torch.eval.classifier import classifier_fid, load_frozen
    from txt2vid_tpu_torch.gan.trainer import sample
    from txt2vid_tpu_torch.gan.cond_gan import load_checkpoint_gan
    from txt2vid_tpu_torch.train.setup import setup
    from txt2vid_tpu_torch.utils import status

    _, device = setup(args)
    vocab = load_pickle(args.vocab) if args.vocab else None
    status(f"Restoring {args.weights}")
    gan, _ = load_checkpoint_gan(
        args.weights, args.G, args.D, sent=args.sent,
        vocab_path=None if args.dont_use_sent else args.vocab,
        frame_sizes=tuple(args.frame_sizes), num_frames=args.num_frames,
        num_channels=args.num_channels, M=args.M)
    for m in (gan.gen, gan.cond_encoder, *gan.discrims):
        if m is not None:
            m.to(device).eval()

    data_kwargs = dict(vocab=vocab, num_frames=args.num_frames,
                       frame_size=args.frame_sizes[-1], num_channels=args.num_channels)
    if args.data.lstrip().startswith("{") or args.data.endswith(".json"):
        dset = create_object(args.data, anno=args.anno, **data_kwargs)
    else:
        dset = VideoDataset(video_dir=args.data, captions=args.anno, **data_kwargs)

    b = args.batch_size
    generator = torch.Generator().manual_seed(args.seed)
    idxs = np.random.default_rng(args.seed).permutation(len(dset))[:args.num]
    reals, fakes = [], []
    for start in range(0, len(idxs) - b + 1, b):
        items = [dset[int(i)] for i in idxs[start:start + b]]
        reals.append(np.stack([v for v, _ in items]))
        cond = None
        if gan.cond_encoder is not None:
            caps, lengths = pad_captions([c for _, c in items], 16)
            with torch.no_grad():
                cond = gan.encode(torch.as_tensor(caps, device=device), lengths)
        fakes.append(sample(gan.gen, b, generator, cond=cond)[-1])

    real = np.concatenate(reals)
    fake = np.concatenate(fakes)
    status(f"evaluating {len(real)} real vs {len(fake)} generated videos")
    feature_fn = None
    if not args.no_discrim_fid:
        def feature_fn(v):
            return discrim_features(gan, v, batch_size=b)
    report = sample_fidelity_report(real, fake, feature_fn=feature_fn, device=device)
    classifier = load_frozen(device=device)
    if classifier is not None:
        report["fid_cls"] = classifier_fid(real, fake, classifier, batch_size=b)
    print(json.dumps(report))
    return report


def build_parser():
    p = argparse.ArgumentParser(description="Sample fidelity of a checkpoint.")
    p.add_argument("--weights", required=True)
    p.add_argument("--G", required=True)
    p.add_argument("--D", nargs="+", required=True)
    p.add_argument("--sent", default=None)
    p.add_argument("--M", default=None,
                   help="the sample mapping the checkpoint was trained with (--M, e.g. "
                        "TCWYT's FrameMap); only its variables are restored")
    p.add_argument("--vocab", default=None)
    p.add_argument("--dont_use_sent", action="store_true")
    p.add_argument("--data", required=True)
    p.add_argument("--anno", default=None)
    p.add_argument("--frame_sizes", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_channels", type=int, default=3)
    p.add_argument("--num", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_discrim_fid", action="store_true",
                   help="skip the trained-discriminator-feature FID")
    p.add_argument("--device", default=None, help="default: cuda")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
