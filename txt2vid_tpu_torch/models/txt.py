"""Bi-LSTM caption encoder and decoder (counterpart of txt2vid_tpu/models/txt.py).

RecurrentModel: Embedding -> `num_layers` LSTM layers (bidirectional with
hidden_size/2 per direction, or one direction of hidden_size) -> per-token
outputs and the sentence encoding hn = [last layer's forward final hidden ‖
backward final hidden]. Padding is handled with pack_padded_sequence, the
counterpart of flax's `seq_lengths` masking. The state is nn.LSTM's (h, c),
each (num_layers * directions, B, per direction) with layer i's forward at
2i and backward at 2i + 1; flax carries (c, h) per layer as [fwd, bwd].

A decoder (`is_decoder`) adds `to_vocab`, a Linear from the hidden state to
the vocabulary, and `sample`, the greedy or teacher-forced decode
(txt.py:80-133): each step runs the whole stack, both directions, on a
length-1 sequence. With teacher forcing the input of step t + 1 is
true_inputs[:, min(t, L - 1)], as the JAX package feeds it: step 1 feeds
token 0 again, so the input lags the target by one.

Seq2Seq decodes with the encoder's weights unless separate_decoder, which
adds a unidirectional decoder `sep_decoder` started from the encoder's
forward states.
"""

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from txt2vid_tpu_torch.ops.initializers import kernel_init_, lecun_normal_, orthogonal_


class RecurrentModel(nn.Module):
    def __init__(self, vocab_size: int, embed_size: int = 256, hidden_size: int = 256,
                 num_layers: int = 4, bi: bool = True, is_decoder: bool = False):
        super().__init__()
        self.bi = bi
        self.num_layers = num_layers
        self.per_dir = hidden_size // 2 if bi else hidden_size
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.lstm = nn.LSTM(embed_size, self.per_dir, num_layers,
                            batch_first=True, bidirectional=bi)
        self.to_vocab = nn.Linear(hidden_size, vocab_size) if is_decoder else None

    def init_weights(self, generator):
        """flax defaults per gate: lecun-normal input kernels, orthogonal
        recurrent kernels, zero biases; the embedding and to_vocab by
        the init method (to_vocab drawn last)."""
        kernel_init_(self.embed.weight, generator=generator)
        for name, p in self.lstm.named_parameters():
            if name.startswith("bias"):
                nn.init.zeros_(p)
                continue
            init = lecun_normal_ if name.startswith("weight_ih") else orthogonal_
            for gate in p.chunk(4, dim=0):
                init(gate, generator=generator)
        if self.to_vocab is not None:
            kernel_init_(self.to_vocab.weight, generator=generator)
            nn.init.zeros_(self.to_vocab.bias)

    def forward(self, x, lengths=None):
        """x: (B, L) int tokens; lengths: (B,) valid lengths (any device or a
        numpy array; packing reads them on the host).
        Returns (out (B, L, hidden), (h_n, c_n), hn (B, hidden))."""
        h = self.embed(x)
        if lengths is None:
            out, (h_n, c_n) = self.lstm(h)
        else:
            packed = pack_padded_sequence(h, torch.as_tensor(lengths).cpu(),
                                          batch_first=True, enforce_sorted=False)
            out, (h_n, c_n) = self.lstm(packed)
            out, _ = pad_packed_sequence(out, batch_first=True,
                                         total_length=x.shape[1])
        hn = torch.cat([h_n[-2], h_n[-1]], dim=-1) if self.bi else h_n[-1]
        return out, (h_n, c_n), hn

    def _step(self, tok, state):
        """One decode step: the token (B,) as a length-1 sequence through the
        whole stack -> (logits (B, V), the new state)."""
        out, state = self.lstm(self.embed(tok)[:, None, :], state)
        return self.to_vocab(out[:, 0]), state

    def sample(self, true_inputs, initial_hidden=None, max_seq_len: int = 60,
               teacher_force: bool = False):
        """Greedy / teacher-forced decode. true_inputs: (B, L) with the start
        token at position 0; initial_hidden: (h, c) in nn.LSTM's layout, zeros
        if None. Returns (raw_outputs (B, max_seq_len, V), symbols (B,
        max_seq_len))."""
        assert self.to_vocab is not None, "sample() needs a decoder (is_decoder=True)"
        b, length = true_inputs.shape
        state = initial_hidden
        if state is None:
            zero = self.embed.weight.new_zeros(
                self.num_layers * (2 if self.bi else 1), b, self.per_dir)
            state = (zero, zero)
        tok = true_inputs[:, 0]
        raws, syms = [], []
        for t in range(max_seq_len):
            logits, state = self._step(tok, state)
            pred = logits.argmax(-1)
            raws.append(logits)
            syms.append(pred)
            tok = true_inputs[:, min(t, length - 1)] if teacher_force else pred
        return torch.stack(raws, 1), torch.stack(syms, 1)


class Seq2Seq(nn.Module):
    def __init__(self, vocab_size: int, embed_size: int = 256, hidden_size: int = 256,
                 num_layers: int = 4, separate_decoder: bool = False):
        super().__init__()
        self.encoding_size = hidden_size
        self.separate_decoder = separate_decoder
        self.encoder = RecurrentModel(vocab_size, embed_size, hidden_size, num_layers,
                                      is_decoder=not separate_decoder)
        self.sep_decoder = (RecurrentModel(vocab_size, embed_size, hidden_size, num_layers,
                                           bi=False, is_decoder=True)
                            if separate_decoder else None)

    @property
    def decoder(self):
        return self.sep_decoder if self.separate_decoder else self.encoder

    def encode(self, x, lengths=None):
        return self.encoder(x, lengths)

    def decode(self, true_inputs, initial_hidden=None, max_seq_len: int = 60,
               teacher_force: bool = False):
        """The decoder's sample(); initial_hidden is the encoder's (h, c), of
        which the separate decoder takes the forward directions."""
        if initial_hidden is not None and self.separate_decoder:
            initial_hidden = tuple(s[0::2] for s in initial_hidden)
        return self.decoder.sample(true_inputs, initial_hidden=initial_hidden,
                                   max_seq_len=max_seq_len, teacher_force=teacher_force)


def trainable(model):
    """Seq2Seq's parameters as flax has them: every one but the LSTMs' bias_ih,
    which is frozen at zero (returned with requires_grad off)."""
    params = []
    for name, p in model.named_parameters():
        if ".bias_ih_" in name:
            with torch.no_grad():
                p.zero_()
            p.requires_grad_(False)
        else:
            params.append(p)
    return params
