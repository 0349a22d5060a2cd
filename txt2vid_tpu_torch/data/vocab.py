"""Caption vocabulary and tokenizer (a copy of `Vocab` / `encode_caption` from
txt2vid_tpu/data/__init__.py and `load_pickle` from txt2vid_tpu/utils/misc.py,
kept here so the port imports nothing of the JAX package).

Specials <pad>=0, <start>, <end>, <unk>; lowercasing; split on spaces, with a
trailing '.' emitted as <end>. `load_pickle` maps a `Vocab` pickled by the JAX
package (`txt2vid_tpu.data.Vocab`) or by the original torch code
(`txt2vid.data.Vocab`) onto this class without importing either.
"""

import pickle

import numpy as np


class Vocab:
    START = "<start>"
    END = "<end>"
    UNKNOWN = "<unk>"
    PAD = "<pad>"  # always index 0

    def __init__(self):
        self.word2idx = {}
        self.idx2word = {}
        self.idx = 0
        for w in (self.PAD, self.START, self.END, self.UNKNOWN):
            self.add_word(w)

    def add_word(self, word):
        word = word.lower()
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def get_word(self, idx):
        return self.idx2word.get(idx, self.UNKNOWN)

    def __call__(self, word):
        word = word.lower()
        return self.word2idx.get(word, self.word2idx[self.UNKNOWN])

    def __len__(self):
        return len(self.word2idx)

    def tokenize(self, sentence):
        yield self.START
        for word in sentence.split():
            if word and word[-1] == ".":
                yield word[:-1]
                yield self.END
            else:
                yield word

    def to_words(self, tokens):
        result = ""
        for i, tok in enumerate(tokens):
            word = self.get_word(int(tok))
            if word != self.END and i != 0:
                result += " "
            result += word
        return result


def build_vocab(sentences):
    vocab = Vocab()
    for sent in sentences:
        for word in vocab.tokenize(sent):
            vocab.add_word(word)
    return vocab


def encode_caption(vocab: Vocab, caption: str) -> np.ndarray:
    toks = [vocab(t) for t in vocab.tokenize(caption)]
    if toks[-1] != vocab(vocab.END):
        toks.append(vocab(vocab.END))
    return np.asarray(toks, dtype=np.int32)


def pad_captions(captions, max_len: int | None = None):
    """Token arrays -> (tokens (N, L) int64, lengths (N,) int64): each cut to
    max_len and zero-padded to L = max_len, or to the longest without it."""
    caps = [np.asarray(c)[:max_len] for c in captions]
    toks = np.zeros((len(caps), max_len or max(len(c) for c in caps)), np.int64)
    for i, c in enumerate(caps):
        toks[i, :len(c)] = c
    return toks, np.asarray([len(c) for c in caps], np.int64)


_VOCAB_MODULES = ("txt2vid.data", "txt2vid_tpu.data")


class _VocabUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _VOCAB_MODULES and name == "Vocab":
            return Vocab
        return super().find_class(module, name)


def load_pickle(path):
    """Load a pickle written by this project, mapping pickled `Vocab`s of the JAX
    package and of the original torch code onto the port's `Vocab`. Unpickling
    runs code: load only files this project wrote."""
    with open(path, "rb") as f:
        return _VocabUnpickler(f).load()
