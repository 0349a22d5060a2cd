from txt2vid_tpu_torch.eval.metrics import (
    fid_from_features, frechet_distance, RandomConvFeatures, sample_fidelity_report)

__all__ = ["fid_from_features", "frechet_distance", "RandomConvFeatures",
           "sample_fidelity_report"]
