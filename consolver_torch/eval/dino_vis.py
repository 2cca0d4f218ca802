"""DINO patch-feature PCA visualisation (a qualitative consistency check).

Port of ``consolver_tpu/eval/dino_vis.py`` (the reference's dino_vis.py:
8-50): the ViT's patch features projected on their 3 principal components
and shown as an RGB map over the patch grid.
"""

from __future__ import annotations

import numpy as np
import torch

from consolver_torch.models.vit import ViT, preprocess


def pca_rgb(patch_features: np.ndarray, grid_hw: tuple[int, int]) -> np.ndarray:
    """``[N, D]`` patch features -> ``[h, w, 3]`` RGB in [0, 1] via PCA(3)."""
    feats = np.asarray(patch_features, np.float64)
    feats = feats - feats.mean(axis=0, keepdims=True)
    # PCA via SVD (the reference uses sklearn PCA(3); identical up to sign)
    _, _, vt = np.linalg.svd(feats, full_matrices=False)
    proj = feats @ vt[:3].T  # [N, 3]
    lo = proj.min(axis=0, keepdims=True)
    hi = proj.max(axis=0, keepdims=True)
    rgb = (proj - lo) / (hi - lo + 1e-8)
    h, w = grid_hw
    return rgb.reshape(h, w, 3).astype(np.float32)


def visualize(vit: ViT, image01: np.ndarray) -> np.ndarray:
    """image ``[H, W, 3]`` in [0, 1] -> the PCA RGB map over the patch grid,
    computed on the ViT's device."""
    device = next(vit.parameters()).device
    x = preprocess(torch.as_tensor(image01, dtype=torch.float32, device=device)[None],
                   vit.cfg.image_size)
    with torch.no_grad():
        hidden = vit(x)[0].float().cpu().numpy()
    patches = hidden[1:] if vit.cfg.class_embedding else hidden
    side = int(np.sqrt(patches.shape[0]))
    return pca_rgb(patches, (side, side))
