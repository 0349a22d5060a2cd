"""Sentence-encoder pretraining CLI (counterpart of txt2vid_tpu/train/txt.py).

Next-token prediction with the Bi-LSTM Seq2Seq: encode each caption, decode
from the encoder's state with teacher forcing drawn per iteration with
probability --teacher_force_p from the numpy generator, and take the masked
mean NLL of tokens 1..L; a seeded 80/10/10 split, the greedy-decode loss on
the validation split every --save_every iterations, optax's default Adam
(b1 0.9, b2 0.999, eps 1e-8) and checkpoints `txt_iter_N` / `txt_final` of
{"optim", "txt": {"params"}} in flax msgpack, which either package's
--sent_weights reads and --weights resumes.

    python -m txt2vid_tpu_torch.train.txt --sentences sent.pickle \\
        --vocab vocab.pickle --out txt_out [--device cpu]

The LSTM's input biases (bias_ih) stay zero and out of the optimizer: flax's
cells have one bias per gate, which bias_hh holds.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from txt2vid_tpu_torch.config import create_object
from txt2vid_tpu_torch.convert import jax_txt_state_to_torch, txt_state_to_jax
from txt2vid_tpu_torch.data import build_vocab, encode_caption, load_pickle
from txt2vid_tpu_torch.models.txt import Seq2Seq, trainable
from txt2vid_tpu_torch.ops.initializers import init_from_seed
from txt2vid_tpu_torch.train.setup import setup
from txt2vid_tpu_torch.utils import RollingAvg, ensure_exists, status
from txt2vid_tpu_torch.utils.checkpoint import restore_state, save_state
from txt2vid_tpu_torch.utils.writer import MetricsWriter


class SentenceDataset:
    """Token-encoded sentences from a {vid: [captions]} pickle, each cut to
    max_len tokens (txt.py:24-45)."""

    def __init__(self, vocab, sents_path, max_len=32):
        sents = load_pickle(sents_path)
        self.vocab = vocab
        self.max_len = max_len
        self.examples = [encode_caption(vocab, s)[:max_len]
                         for v in sents for s in sents[v]]

    def __len__(self):
        return len(self.examples)

    def batch(self, idxs):
        """-> (captions (B, max_len) int64 zero-padded, lengths (B,) int64)."""
        caps = np.zeros((len(idxs), self.max_len), np.int64)
        lengths = np.zeros((len(idxs),), np.int64)
        for i, j in enumerate(idxs):
            c = self.examples[j]
            caps[i, :len(c)] = c
            lengths[i] = len(c)
        return caps, lengths


def txt_loss(model, caps, lengths, teacher_force: bool):
    """Masked mean NLL of tokens 1..L decoded from the encoder's state
    (txt.py:48-64). caps (B, max_len) on the model's device, lengths (B,)."""
    max_len = caps.shape[1]
    _, states, _ = model.encode(caps, lengths)
    raw, _ = model.decode(caps, initial_hidden=states, max_seq_len=max_len - 1,
                          teacher_force=teacher_force)
    lengths = torch.as_tensor(lengths, device=caps.device)
    mask = (torch.arange(max_len - 1, device=caps.device)[None, :]
            < (lengths - 1)[:, None]).to(raw.dtype)
    nll = -F.log_softmax(raw, dim=-1).gather(-1, caps[:, 1:, None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def make_step(model, opt):
    def step(caps, lengths, teacher_force):
        model.train()
        loss = txt_loss(model, caps, lengths, teacher_force)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


@torch.no_grad()
def eval_loss(model, caps, lengths):
    return txt_loss(model, caps, lengths, False)


def main(args):
    seed, device = setup(args)

    if args.vocab:
        vocab = load_pickle(args.vocab)
    else:
        sents = load_pickle(args.sentences)
        vocab = build_vocab([s for v in sents for s in sents[v]])
    status(f"vocab size {len(vocab)}")

    dset = SentenceDataset(vocab, args.sentences, max_len=args.max_len)
    n = len(dset)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_train, n_val = int(0.8 * n), int(0.1 * n)
    train_idx = order[:n_train]
    val_idx = order[n_train:n_train + n_val]
    status(f"{n} sentences: {len(train_idx)} train / {len(val_idx)} val")

    model = (create_object(args.model, vocab_size=len(vocab)) if args.model
             else Seq2Seq(vocab_size=len(vocab)))
    init_from_seed(model, seed).to(device)
    opt = torch.optim.Adam(trainable(model), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    step = make_step(model, opt)
    if args.weights:
        status(f"Resuming from {args.weights}")
        jax_txt_state_to_torch(restore_state(txt_state_to_jax(model, opt), args.weights),
                               model, opt)

    def put(idxs):
        caps, lengths = dset.batch(idxs)
        return torch.from_numpy(caps).to(device), torch.from_numpy(lengths)

    ensure_exists(args.out)
    writer = MetricsWriter(args.out)
    avg = RollingAvg(20)
    it = 0
    for epoch in range(args.epochs):
        rng.shuffle(train_idx)
        for b in range(len(train_idx) // args.batch_size):
            caps, lengths = put(train_idx[b * args.batch_size:(b + 1) * args.batch_size])
            tf = rng.random() < args.teacher_force_p
            loss = step(caps, lengths, tf)
            avg.update(float(loss))
            it += 1
            if it % args.log_every == 0:
                status(f"epoch {epoch} iter {it}: loss {avg.get():.4f}")
                writer.add_scalar("loss/train", avg.get(), it)
            if it % args.save_every == 0:
                vloss = 0.0
                nb = max(len(val_idx) // args.batch_size, 1)
                for vb in range(nb):
                    vloss += float(eval_loss(model, *put(
                        val_idx[vb * args.batch_size:(vb + 1) * args.batch_size])))
                status(f"val loss: {vloss / nb:.4f}")
                writer.add_scalar("loss/val", vloss / nb, it)
                save_state(txt_state_to_jax(model, opt), f"{args.out}/txt_iter_{it}")
    save_state(txt_state_to_jax(model, opt), f"{args.out}/txt_final")
    writer.close()
    status(f"saved {args.out}/txt_final")
    return model, opt


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sentences", required=True, help="{vid: [captions]} pickle")
    p.add_argument("--vocab", default=None)
    p.add_argument("--model", default=None, help="Seq2Seq component spec")
    p.add_argument("--out", default="txt_out")
    p.add_argument("--weights", default=None, help="a txt_* checkpoint to resume from")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--teacher_force_p", type=float, default=0.5)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="default: cuda")
    return p


def cli(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
