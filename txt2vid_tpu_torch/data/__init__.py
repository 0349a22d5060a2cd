"""Host-side data for the port: caption vocabulary and synthetic captions."""

from txt2vid_tpu_torch.data.vocab import Vocab, build_vocab, encode_caption, load_pickle

__all__ = ["Vocab", "build_vocab", "encode_caption", "load_pickle"]
