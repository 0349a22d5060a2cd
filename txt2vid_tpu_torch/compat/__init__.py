"""Interop with the original PyTorch code (counterpart of
txt2vid_tpu/compat/): import its trained checkpoints into the port."""

from txt2vid_tpu_torch.compat.torch_import import (  # noqa: F401
    converter_for,
    img_discrim_vars,
    img_gen_vars,
    multiscale_discrim_vars,
    multiscale_gen_vars,
    seq2seq_vars,
    tcwyt_frame_discrim_vars,
    tcwyt_frame_map_vars,
    tcwyt_gen_vars,
    tcwyt_motion_discrim_vars,
    tcwyt_video_discrim_vars,
    tgan_gen_vars,
)
