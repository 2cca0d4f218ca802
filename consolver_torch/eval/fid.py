"""Frechet Inception Distance, computed in-repo.

Port of ``consolver_tpu/eval/fid.py`` (the reference uses clean-fid,
fid_test.py:1-16).  The statistics and the distance are numpy / scipy on
the host; the feature extractor is pluggable (``encode_fn``: images
``[B, H, W, 3]`` in [0, 1] -> features ``[B, D]``), for example
``models.inception.make_inception_encoder(InceptionV3(num_classes=0))``,
the pool3 features.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch

from consolver_torch.device import resolve_device


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, covariance) of ``[N, D]`` features."""
    return features.mean(axis=0), np.cov(features, rowvar=False)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """``||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))``."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if isinstance(covmean, tuple):  # older scipy returns (sqrtm, errest)
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))


def _features(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                  batches: Iterable, device=None) -> np.ndarray:
    """``[N, D]`` f32 features of a stream of image batches (numpy arrays or
    tensors), each encoded on ``device`` (None = the GPU) without autograd."""
    device = resolve_device(device)
    feats = []
    with torch.no_grad():
        for batch in batches:
            feats.append(encode_fn(torch.as_tensor(batch, device=device)).float().cpu().numpy())
    return np.concatenate(feats)


def compute_fid(
    encode_fn: Callable[[torch.Tensor], torch.Tensor],
    generated: Iterable,
    reference: Iterable,
    device=None,
) -> float:
    """FID between two streams of image batches (``[B, H, W, 3]`` in [0, 1])."""
    mu1, c1 = feature_statistics(_features(encode_fn, generated, device))
    mu2, c2 = feature_statistics(_features(encode_fn, reference, device))
    return frechet_distance(mu1, c1, mu2, c2)
