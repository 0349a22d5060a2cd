from txt2vid_tpu_torch.ops.subsample import multiscale_pyramid, subsample_rect, subsample_video

__all__ = ["subsample_video", "subsample_rect", "multiscale_pyramid"]
