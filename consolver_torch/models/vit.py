"""ViT image encoders of the rewards: DINOv2-base and CLIP-ViT-L/14.

Port of ``consolver_tpu/models/vit.py``.  One configurable ViT covers both
towers; ``ViTConfig.layout`` says which checkpoint's key names its modules
take, so that a transformers state dict loads as it is and the JAX
converters (``convert_dinov2``, ``convert_clip_vision``) read the port's:

  * ``"dinov2"`` (``Dinov2Model``): ``embeddings.{cls_token,
    position_embeddings, patch_embeddings.projection}``,
    ``encoder.layer.N.{norm1, attention.attention.{query,key,value},
    attention.output.dense, layer_scale1.lambda1, norm2, mlp.fc1, mlp.fc2,
    layer_scale2.lambda1}``, ``layernorm``;
  * ``"clip"`` (``CLIPVisionModelWithProjection``, the layout of a config
    with quick-GELU): ``vision_model.embeddings.{class_embedding
    [hidden], patch_embedding, position_embedding.weight [N, hidden]}``,
    ``vision_model.pre_layrnorm``, ``vision_model.encoder.layers.N.
    {layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2, mlp.fc1,
    mlp.fc2}``, ``vision_model.post_layernorm``, ``visual_projection``.

Numerics kept from the JAX package: LayerNorms run in f32 and are cast to
the model dtype (the final one stays f32); DINOv2's MLP uses the tanh GELU
(flax ``nn.gelu``'s default; transformers uses the exact one), CLIP's
quick-GELU; LayerScale multiplies each branch; CLIP's patch convolution has
no bias and its projection takes the CLS token.  Attention goes through
:func:`consolver_torch.kernels.attention.attention` (kernel #1 on the card).
Public calls are NHWC; the patch convolution runs NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from consolver_torch.device import resolve_device
from consolver_torch.kernels.attention import attention as attention_op
from consolver_torch.models.layers import layer_norm_f32, nchw_to_tokens
from consolver_torch.utils.resize import resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# transformers key -> JAX module path, copied from
# ``consolver_tpu/models/vit.py::convert_dinov2`` / ``convert_clip_vision``
# (:220-273); ``load_jax_params`` reads them to find each leaf.
DINOV2_RENAMES = (
    (r"^embeddings\.patch_embeddings\.projection\.", "patch_embed."),
    (r"^embeddings\.cls_token$", "cls_token"),
    (r"^embeddings\.position_embeddings$", "pos_embed"),
    (r"^encoder\.layer\.(\d+)\.norm1\.", r"blocks.\1.norm1."),
    (r"^encoder\.layer\.(\d+)\.norm2\.", r"blocks.\1.norm2."),
    (r"^encoder\.layer\.(\d+)\.attention\.attention\.query\.", r"blocks.\1.q."),
    (r"^encoder\.layer\.(\d+)\.attention\.attention\.key\.", r"blocks.\1.k."),
    (r"^encoder\.layer\.(\d+)\.attention\.attention\.value\.", r"blocks.\1.v."),
    (r"^encoder\.layer\.(\d+)\.attention\.output\.dense\.", r"blocks.\1.proj."),
    (r"^encoder\.layer\.(\d+)\.layer_scale1\.lambda1$", r"blocks.\1.ls1"),
    (r"^encoder\.layer\.(\d+)\.layer_scale2\.lambda1$", r"blocks.\1.ls2"),
    (r"^encoder\.layer\.(\d+)\.mlp\.fc1\.", r"blocks.\1.fc1."),
    (r"^encoder\.layer\.(\d+)\.mlp\.fc2\.", r"blocks.\1.fc2."),
    (r"^layernorm\.", "norm."),
)
CLIP_RENAMES = (
    (r"^vision_model\.embeddings\.patch_embedding\.", "patch_embed."),
    (r"^vision_model\.embeddings\.class_embedding$", "cls_token"),
    (r"^vision_model\.embeddings\.position_embedding\.weight$", "pos_embed"),
    (r"^vision_model\.pre_layrnorm\.", "pre_norm."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.", r"blocks.\1.norm1."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.", r"blocks.\1.norm2."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.q_proj\.", r"blocks.\1.q."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.k_proj\.", r"blocks.\1.k."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.v_proj\.", r"blocks.\1.v."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.out_proj\.", r"blocks.\1.proj."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.", r"blocks.\1.fc1."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.", r"blocks.\1.fc2."),
    (r"^vision_model\.post_layernorm\.", "norm."),
    (r"^visual_projection\.", "visual_projection."),
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layerscale: bool = True  # DINOv2 LayerScale
    quick_gelu: bool = False  # CLIP uses quick_gelu
    pre_norm_embed: bool = False  # CLIP pre_layrnorm
    class_embedding: bool = True
    patch_bias: bool = True  # CLIP's patch embedding conv has no bias
    projection_dim: Optional[int] = None  # CLIP image projection
    ln_eps: float = 1e-6

    @classmethod
    def dinov2_base(cls) -> "ViTConfig":
        return cls(patch_size=14, hidden_size=768, num_layers=12, num_heads=12,
                   layerscale=True, ln_eps=1e-6)

    @classmethod
    def clip_vit_l14(cls) -> "ViTConfig":
        return cls(patch_size=14, hidden_size=1024, num_layers=24, num_heads=16,
                   layerscale=False, quick_gelu=True, pre_norm_embed=True,
                   patch_bias=False, projection_dim=768, ln_eps=1e-5)

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                   num_heads=2)

    @property
    def layout(self) -> str:
        """The checkpoint whose key names the modules take."""
        return "clip" if self.quick_gelu else "dinov2"

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + int(self.class_embedding)


def container(**children: nn.Module) -> nn.Module:
    """A module that only names its children (a checkpoint's key level)."""
    module = nn.Module()
    for name, child in children.items():
        module.add_module(name, child)
    return module


class _LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(dim))


class ViTBlock(nn.Module):
    """Pre-norm block: LN -> attention (-> LayerScale) -> residual, LN ->
    MLP (-> LayerScale) -> residual.  The submodules sit under the layout's
    key names; ``_parts`` holds them for the forward."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        h, mlp = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
        norm1, norm2 = nn.LayerNorm(h, eps=cfg.ln_eps), nn.LayerNorm(h, eps=cfg.ln_eps)
        q, k, v, proj = (nn.Linear(h, h) for _ in range(4))
        fc1, fc2 = nn.Linear(h, mlp), nn.Linear(mlp, h)
        ls1 = ls2 = None
        if cfg.layout == "clip":
            if cfg.layerscale:
                raise ValueError("the CLIP layout has no LayerScale")
            self.layer_norm1 = norm1
            self.self_attn = container(q_proj=q, k_proj=k, v_proj=v, out_proj=proj)
            self.layer_norm2 = norm2
        else:
            self.norm1 = norm1
            self.attention = container(attention=container(query=q, key=k, value=v),
                                       output=container(dense=proj))
            self.norm2 = norm2
            if cfg.layerscale:
                ls1, ls2 = _LayerScale(h), _LayerScale(h)
                self.layer_scale1, self.layer_scale2 = ls1, ls2
        self.mlp = container(fc1=fc1, fc2=fc2)
        # a tuple is not registered: the same modules, named once above
        self._parts = (norm1, q, k, v, proj, ls1, norm2, fc1, fc2, ls2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm1, q, k, v, proj, ls1, norm2, fc1, fc2, ls2 = self._parts
        cfg = self.cfg
        b, s, h = x.shape
        heads = (b, s, cfg.num_heads, h // cfg.num_heads)
        y = layer_norm_f32(norm1, x).to(q.weight.dtype)
        attn = attention_op(q(y).reshape(heads), k(y).reshape(heads), v(y).reshape(heads))
        attn = proj(attn.reshape(b, s, h))
        if ls1 is not None:
            attn = attn * ls1.lambda1
        x = x + attn
        y = fc1(layer_norm_f32(norm2, x).to(fc1.weight.dtype))
        y = y * torch.sigmoid(1.702 * y) if cfg.quick_gelu else F.gelu(y, approximate="tanh")
        y = fc2(y)
        if ls2 is not None:
            y = y * ls2.lambda1
        return x + y


class ViT(nn.Module):
    """images NHWC (already preprocessed / normalised) -> hidden states
    ``[B, 1+N, hidden]`` (f32, after the final LayerNorm); :meth:`features`
    returns the reward feature vector (the CLS hidden state for DINOv2, the
    projected CLS for CLIP)."""

    def __init__(self, cfg: ViTConfig, device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        h, p = cfg.hidden_size, cfg.patch_size
        self.jax_renames = CLIP_RENAMES if cfg.layout == "clip" else DINOV2_RENAMES
        with torch.device(resolve_device(device)):
            patch = nn.Conv2d(3, h, p, stride=p, bias=cfg.patch_bias)
            blocks = nn.ModuleList([ViTBlock(cfg) for _ in range(cfg.num_layers)])
            norm = nn.LayerNorm(h, eps=cfg.ln_eps)
            cls = nn.Parameter(torch.zeros(1, 1, h)) if cfg.class_embedding else None
            pos = nn.Parameter(torch.randn(1, cfg.num_positions, h) * 0.02)
            pre_norm = nn.LayerNorm(h, eps=cfg.ln_eps) if cfg.pre_norm_embed else None
            projection = (nn.Linear(h, cfg.projection_dim, bias=False)
                          if cfg.projection_dim is not None else None)
        if cfg.layout == "clip":
            embeddings = container(patch_embedding=patch)
            if cls is not None:
                embeddings.class_embedding = nn.Parameter(cls.data.reshape(h))
            embeddings.position_embedding = container()
            embeddings.position_embedding.weight = nn.Parameter(pos.data.reshape(-1, h))
            self.vision_model = container(embeddings=embeddings, encoder=container(layers=blocks))
            if pre_norm is not None:
                self.vision_model.pre_layrnorm = pre_norm
            self.vision_model.post_layernorm = norm
        else:
            embeddings = container(patch_embeddings=container(projection=patch))
            if cls is not None:
                embeddings.cls_token = cls
            embeddings.position_embeddings = pos
            self.embeddings = embeddings
            self.encoder = container(layer=blocks)
            if pre_norm is not None:
                self.pre_norm = pre_norm
            self.layernorm = norm
        if projection is not None:
            self.visual_projection = projection
        self._parts = (patch, blocks, norm, pre_norm, projection)
        if dtype is not None:
            self.to(dtype)

    def _tables(self):
        """The class token (or None) and the position table."""
        if self.cfg.layout == "clip":
            emb = self.vision_model.embeddings
            return emb._parameters.get("class_embedding"), emb.position_embedding.weight
        return self.embeddings._parameters.get("cls_token"), self.embeddings.position_embeddings

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the tokens entering the first block."""
        patch, _, _, pre_norm, _ = self._parts
        cfg = self.cfg
        dtype = patch.weight.dtype
        x = nchw_to_tokens(patch(images.to(dtype).permute(0, 3, 1, 2)))
        cls, pos = self._tables()
        b, h = x.shape[0], cfg.hidden_size
        if cls is not None:
            x = torch.cat([cls.reshape(1, 1, h).to(dtype).expand(b, 1, h), x], dim=1)
        pos = pos.reshape(1, -1, h)
        if pos.shape[1] != x.shape[1]:
            pos = _interpolate_pos(pos, x.shape[1], cls is not None)
        x = x + pos.to(dtype)
        if pre_norm is not None:
            x = layer_norm_f32(pre_norm, x).to(dtype)
        return x

    def forward(self, images: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        _, blocks, norm, _, projection = self._parts
        x = self.embed(images)
        for block in blocks:
            x = block(x)
        hidden = layer_norm_f32(norm, x)
        if not return_features:
            return hidden
        if projection is not None:
            return projection(hidden[:, 0].to(projection.weight.dtype))
        return hidden[:, 0]

    def taps(self, images: torch.Tensor, out_indices: Sequence[int]) -> list:
        """The final LayerNorm's f32 output after each 1-based block index in
        ``out_indices`` (transformers ``Dinov2Backbone``, apply_layernorm)."""
        _, blocks, norm, _, _ = self._parts
        x, out = self.embed(images), []
        for i, block in enumerate(blocks):
            x = block(x)
            if i + 1 in out_indices:
                out.append(layer_norm_f32(norm, x))
        return out

    def features(self, images: torch.Tensor) -> torch.Tensor:
        return self(images, return_features=True)


def _interpolate_pos(pos: torch.Tensor, n_target: int, has_cls: bool) -> torch.Tensor:
    """Bilinear position-embedding interpolation for off-grid image sizes."""
    cls_part = pos[:, :1] if has_cls else pos[:, :0]
    grid = pos[:, 1:] if has_cls else pos
    src = int(np.sqrt(grid.shape[1]))
    dst = int(np.sqrt(n_target - (1 if has_cls else 0)))
    grid = resize(grid.reshape(1, src, src, -1), (1, dst, dst, grid.shape[-1]), "linear")
    return torch.cat([cls_part, grid.reshape(1, dst * dst, -1)], dim=1)


def preprocess(
    images: torch.Tensor,
    size: int = 224,
    mean: Tuple[float, ...] = IMAGENET_MEAN,
    std: Tuple[float, ...] = IMAGENET_STD,
    resize_to: Optional[int] = 256,
    method: str = "linear",
) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 1] -> resized, center-cropped, normalised
    ``[B, size, size, 3]``: the shortest edge to ``resize_to`` (or the whole
    image to ``size`` when None), then the crop (the hub processors' recipe,
    with JAX's resize in place of PIL's)."""
    b, h, w, c = images.shape
    if resize_to is not None:
        scale = resize_to / min(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        images = resize(images, (b, nh, nw, c), method)
        h, w = nh, nw
    else:
        images = resize(images, (b, size, size, c), method)
        h = w = size
    top, left = (h - size) // 2, (w - size) // 2
    images = images[:, top:top + size, left:left + size, :]
    mean_t = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (images - mean_t) / std_t


def make_encoder(vit: ViT, kind: str = "dino"):
    """The ``RewardModel.encode`` callable: batched preprocess + features."""
    if kind == "dino":
        # BitImageProcessor: shortest-edge 256 bilinear + crop 224
        mean, std, resize_to, method = IMAGENET_MEAN, IMAGENET_STD, 256, "linear"
    elif kind == "clip":
        # CLIPImageProcessor: bicubic, the whole image to 224
        mean, std, resize_to, method = CLIP_MEAN, CLIP_STD, None, "cubic"
    else:
        mean, std, resize_to, method = IMAGENET_MEAN, IMAGENET_STD, None, "linear"

    def encode(images: torch.Tensor) -> torch.Tensor:
        return vit.features(preprocess(images, vit.cfg.image_size, mean, std, resize_to, method))

    encode.model = vit
    return encode
