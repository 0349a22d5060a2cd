"""Bi-LSTM caption encoder (counterpart of txt2vid_tpu/models/txt.py).

RecurrentModel: Embedding -> `num_layers` bidirectional LSTM (hidden_size/2 per
direction) -> per-token outputs and the sentence encoding hn = [last layer's
forward final hidden ‖ backward final hidden]. Padding is handled with
pack_padded_sequence, the counterpart of flax's `seq_lengths` masking. The
decoder (`sample`) waits for a later slice; its output projection `to_vocab`
is held as two buffers outside the state dict, unused by the encoder, so a
JAX train state passes through the port with it unchanged.
"""

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from txt2vid_tpu_torch.ops.initializers import kernel_init_, lecun_normal_, orthogonal_


class RecurrentModel(nn.Module):
    def __init__(self, vocab_size: int, embed_size: int = 256, hidden_size: int = 256,
                 num_layers: int = 4):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.lstm = nn.LSTM(embed_size, hidden_size // 2, num_layers,
                            batch_first=True, bidirectional=True)
        # the decoder's Dense(vocab_size) over the hidden state, torch layout
        self.register_buffer("to_vocab_weight", torch.zeros(vocab_size, hidden_size),
                             persistent=False)
        self.register_buffer("to_vocab_bias", torch.zeros(vocab_size), persistent=False)

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
        kernel_init_(self.to_vocab_weight, generator=generator)
        nn.init.zeros_(self.to_vocab_bias)

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
        hn = torch.cat([h_n[-2], h_n[-1]], dim=-1)
        return out, (h_n, c_n), hn


class Seq2Seq(nn.Module):
    """The encoder half of the JAX Seq2Seq (shared-weight decoder not ported)."""

    def __init__(self, vocab_size: int, embed_size: int = 256, hidden_size: int = 256,
                 num_layers: int = 4):
        super().__init__()
        self.encoding_size = hidden_size
        self.encoder = RecurrentModel(vocab_size, embed_size, hidden_size, num_layers)

    def encode(self, x, lengths=None):
        return self.encoder(x, lengths)
