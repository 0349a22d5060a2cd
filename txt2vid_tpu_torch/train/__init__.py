"""Training entry points of the port: `python -m txt2vid_tpu_torch.train.gan`."""
