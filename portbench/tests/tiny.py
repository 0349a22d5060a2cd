"""A configuration small enough for the CPU: the benchmark's model spec at
tiny widths, in the same layout as the files under portbench/configs."""

import copy

SPEC = {
    "name": "tiny",
    "dtype": "float32",
    "G": {"class": "txt2vid_tpu_torch.models.tganv2_cond.MultiScaleGen",
          "args": {"latent_size": 8, "width": 32, "height": 32, "num_channels": 3,
                   "additional_blocks": [16, 8], "fm_channels": 16, "num_frames": 4,
                   "fm_stride": 32, "with_non_local": True, "remat": False}},
    "D": {"class": "txt2vid_tpu_torch.models.tganv2_cond.MultiScaleDiscrim",
          "args": {"num_channels": 3, "cond_head": "proj", "discrim_down_blocks": [2, 2, 2]}},
    "sent": {"class": "txt2vid_tpu_torch.models.txt.Seq2Seq",
             "args": {"embed_size": 8, "hidden_size": 8, "num_layers": 2}},
    "train": {"frame_sizes": [8, 16, 32], "subsample_input": True, "batch_size": 4,
              "D_loss": "txt2vid_tpu_torch.gan.losses.RSGANLoss", "gp_lambda": 1.0,
              "gp_every": 2, "G_lr": 2e-4, "D_lr": 1e-4, "G_beta1": 0.5, "G_beta2": 0.999,
              "D_beta1": 0.5, "D_beta2": 0.999, "clip_grad": 100.0, "g_ema": 0.999,
              "bf16": False, "bf16_nu": False, "bf16_params": False, "log_period": 2,
              "max_caption_len": 32},
    "dataset": {"clips": 12, "format": "packed"},
    "serve": {"bf16": False, "batch_size": 2, "max_caption_len": 16, "calibration_batch": 4},
    "limits": {},
}


def spec(**train):
    s = copy.deepcopy(SPEC)
    s["train"].update(train)
    return s
