"""Checkpoints without jax, orbax or the ``safetensors`` package.

Port of the JAX package's weight path: ``scripts/convert_checkpoints.py``
(reading hub directories), ``consolver_tpu/models/convert.py`` (hub key ->
parameter) and ``policy/io.load_orbax`` (reading a converted checkpoint).

**safetensors.**  :class:`SafetensorsFile` reads the format itself: an
8-byte little-endian header length, a JSON header (each tensor's ``dtype``,
``shape`` and ``data_offsets`` into the data that follows, an optional
``__metadata__`` of strings) and the raw little-endian bytes.  Tensors are
``torch.frombuffer`` views of a read-only ``mmap`` of their bytes in the
file (no numpy, which has no bf16); a header that runs past the file, or offsets that
overlap, leave a gap, run past the data or do not fit the shape, raise.
:func:`save_file` writes the same format, its header padded with spaces to
a multiple of 8 bytes and its tensors in the package's order (larger item
sizes first, then by name), and :func:`save_sharded` splits a state dict
over ``model-0000k-of-0000n.safetensors`` files with the hub's
``model.safetensors.index.json`` beside them.

**Hub directories.**  :func:`checkpoint_files` finds the weights as the JAX
converter does (``convert_checkpoints.py:33-45``): every ``*.safetensors``
in sorted order, else the ``*.bin`` / ``*.pth`` / ``*.ckpt`` files, read
with ``torch.load(weights_only=True)``; an index JSON beside the shards is
only a listing.  :func:`hub_key_map` maps each hub key of a kind (unet,
vae, clip_text, clip_vision, dinov2, t5, flux, factor_net, depth_anything,
segformer, inception; and the port's own sd3_transformer, diffusers'
``SD3Transformer2DModel``, and clip_text_proj, transformers'
``CLIPTextModelWithProjection`` with its ``text_projection``) to the
parameter that ``load_jax_params`` fills from
the JAX converter's tree: the key is dropped by the converter's skip
patterns (and the kind's own drops), renamed by the converter's table for
the kind (the old SD VAE attention names, CLIP's, FLUX's, T5's, the
reference FactorNet's ``mlp.0/2/4``, or the backbone's ``jax_renames``),
turned into its JAX tree path, and matched to the module key whose JAX path
it is.  The converters' transposes cancel (OIHW -> HWIO -> OIHW, and so on),
so a value loads as it is, reshaped where the module keeps another shape
(CLIP's class token and positions).  A hub key with no parameter, or a
parameter with no hub key, raises and names them.

**Loading.**  A module is built on ``meta`` and filled one file at a time
with ``load_state_dict(assign=True)``: each tensor goes to the device in
the dtype of the module's tensor (the model's dtype, through
:func:`~consolver_torch.utils.trees.cast_floating`) from a memory map of
its own bytes, unmapped once copied, so the host never maps more than one
tensor of the checkpoint at a time (a ``torch.load`` file is read whole).  A BatchNorm's ``num_batches_tracked``,
which has no checkpoint value, keeps 0.

**The port's layout.**  A component directory holds ``model.safetensors``
(or shards) with the module's own keys, and ``{directory}_config.json``
beside the directory holds its config dataclass, as the JAX converter
writes it (lists read back as tuples, nested dataclasses rebuilt), so a
JAX-written sidecar loads too.  A quantized component (int8 ``kernel`` and
``kernel_scale``, or int4 ``kernel_packed`` and group ``kernel_scale``;
the sidecar sets ``quant_int8`` / ``quant_int4``) loads verbatim: its float
residue keeps the dtypes it was saved in.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import mmap
import os
import re
import struct
import typing
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from consolver_torch.models.convert import _canonical, jax_path
from consolver_torch.utils.trees import cast_floating

DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "I32": torch.int32, "I64": torch.int64, "F16": torch.float16, "BF16": torch.bfloat16,
    "F32": torch.float32, "F64": torch.float64,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}
WEIGHTS_FILE = "model.safetensors"
INDEX_FILE = "model.safetensors.index.json"
MAX_HEADER_BYTES = 100 << 20


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


class SafetensorsFile:
    """One ``.safetensors`` file: its header, read and checked at open, and
    its tensors as read-only CPU views of a memory map."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: {size} bytes, shorter than the header length")
            (n,) = struct.unpack("<Q", head)
            if n > min(size - 8, MAX_HEADER_BYTES):
                raise ValueError(f"{path}: header of {n} bytes past the file's {size}")
            header = json.loads(f.read(n))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self.data_start = 8 + n
        self.entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        spans = []
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of "
                                 f"{sorted(DTYPES)}")
            dtype, shape = DTYPES[info["dtype"]], tuple(int(d) for d in info["shape"])
            begin, end = (int(o) for o in info["data_offsets"])
            numel = 1
            for d in shape:
                numel *= d
            if end - begin != numel * _itemsize(dtype) or begin < 0:
                raise ValueError(f"{path}: {name}'s offsets [{begin}, {end}) do not fit "
                                 f"{info['dtype']} {list(shape)}")
            self.entries[name] = (dtype, shape, begin, end)
            spans.append((begin, end, name))
        at = 0
        for begin, end, name in sorted(spans):
            if begin != at:
                raise ValueError(f"{path}: {name} starts at {begin}, want {at} (tensors must "
                                 "tile the data without overlap)")
            at = end
        if self.data_start + at != size:
            raise ValueError(f"{path}: the tensors end at byte {self.data_start + at} of {size}")

    def keys(self) -> List[str]:
        return list(self.entries)

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.entries[name][1]

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name``: a read-only CPU view of a memory map of its
        own bytes, unmapped when the last view of it goes (copy it before
        writing to it or changing the file)."""
        dtype, shape, begin, end = self.entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        start = self.data_start + begin
        base = start - start % mmap.ALLOCATIONGRANULARITY
        with open(self.path, "rb") as f:
            view = mmap.mmap(f.fileno(), start + end - begin - base, offset=base,
                             access=mmap.ACCESS_READ)
        offset = start - base
        if offset % _itemsize(dtype):  # an unaligned tensor: copy its bytes out
            return torch.frombuffer(bytearray(view[offset:offset + end - begin]),
                                    dtype=dtype).reshape(shape)
        with warnings.catch_warnings():  # a read-only mapping: never written through
            warnings.simplefilter("ignore", UserWarning)
            return torch.frombuffer(view, dtype=dtype, count=(end - begin) // _itemsize(dtype),
                                    offset=offset).reshape(shape)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, copied into CPU memory."""
    f = SafetensorsFile(path)
    return {name: f.get(name).clone() for name in f.keys()}


def _header_and_order(tensors: Dict[str, torch.Tensor], metadata: Optional[Dict[str, str]]):
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    at = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in DTYPE_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} cannot be written to safetensors")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + n]}
        at += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return raw, order


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device; moved to the CPU one at a time) to
    ``path``; returns the bytes written."""
    raw, order = _header_and_order(tensors, metadata)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)
    return os.path.getsize(path)


def save_sharded(tensors: Dict[str, torch.Tensor], directory: str,
                 max_shard_bytes: Optional[int] = None,
                 metadata: Optional[Dict[str, str]] = None) -> List[str]:
    """``model.safetensors`` in ``directory``, or with ``max_shard_bytes``
    the hub's ``model-0000k-of-0000n.safetensors`` shards (in key order, a
    new shard when the next tensor would pass the limit) and
    ``model.safetensors.index.json``; returns the files written."""
    os.makedirs(directory, exist_ok=True)
    if max_shard_bytes is None:
        path = os.path.join(directory, WEIGHTS_FILE)
        save_file(tensors, path, metadata)
        return [path]
    shards: List[List[str]] = [[]]
    size = 0
    for name in tensors:
        n = tensors[name].numel() * tensors[name].element_size()
        if shards[-1] and size + n > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += n
    files, weight_map = [], {}
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file({k: tensors[k] for k in names}, os.path.join(directory, fname), metadata)
        files.append(os.path.join(directory, fname))
        weight_map.update({k: fname for k in names})
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    with open(os.path.join(directory, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return files


# ---------------------------------------------------------------------------
# weight files of a directory
# ---------------------------------------------------------------------------


def checkpoint_files(src: str) -> List[str]:
    """The weight files of ``src`` (a directory or one file): every
    ``*.safetensors`` in sorted order, else the ``*.bin``, ``*.pth`` and
    ``*.ckpt`` files."""
    if os.path.isfile(src):
        return [src]
    files = sorted(glob.glob(os.path.join(src, "*.safetensors")))
    if files:
        return files
    files = (sorted(glob.glob(os.path.join(src, "*.bin")))
             + sorted(glob.glob(os.path.join(src, "*.pth")))
             + sorted(glob.glob(os.path.join(src, "*.ckpt"))))
    if not files:
        raise FileNotFoundError(f"No safetensors/bin/pth/ckpt weights under {src}")
    return files


class _TorchFile:
    """A ``torch.load`` checkpoint behind the :class:`SafetensorsFile`
    interface (read whole: pickled files have no lazy header)."""

    def __init__(self, path: str):
        self.tensors = torch.load(path, map_location="cpu", weights_only=True)

    def keys(self) -> List[str]:
        return list(self.tensors)

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.tensors[name].shape)

    def get(self, name: str) -> torch.Tensor:
        return self.tensors[name]


def open_files(src: str):
    """The readers of :func:`checkpoint_files`, one per file."""
    return [SafetensorsFile(f) if f.endswith(".safetensors") else _TorchFile(f)
            for f in checkpoint_files(src)]


def read_state_dict(src: str) -> Dict[str, torch.Tensor]:
    """Every tensor under ``src``, copied into CPU memory."""
    state = {}
    for f in open_files(src):
        state.update({k: f.get(k).clone() for k in f.keys()})
    return state


# ---------------------------------------------------------------------------
# hub keys -> module keys
# ---------------------------------------------------------------------------

# consolver_tpu/models/convert.py:34-95 and the kind converters' tables
SKIP_PATTERNS = (r"position_ids$", r"num_batches_tracked$", r"mask_token$", r"^logit_scale$",
                 r"text_projection")
EMBED_PARENTS = ("token_embedding", "position_embedding", "shared", "embed_tokens")
VAE_ATTN_RENAMES = ((r"\.query\.", ".to_q."), (r"\.key\.", ".to_k."), (r"\.value\.", ".to_v."),
                    (r"\.proj_attn\.", ".to_out.0."))
CLIP_TEXT_RENAMES = (
    (r"^text_model\.", ""),
    (r"^embeddings\.token_embedding", "token_embedding"),
    (r"^embeddings\.position_embedding", "position_embedding"),
    (r"^encoder\.layers\.", "layers."),
    (r"\.mlp\.fc1\.", ".mlp_fc1."),
    (r"\.mlp\.fc2\.", ".mlp_fc2."),
)
FLUX_RENAMES = (
    (r"^time_text_embed\.timestep_embedder", "timestep_embedder"),
    (r"^time_text_embed\.guidance_embedder", "guidance_embedder"),
    (r"^time_text_embed\.text_embedder", "text_embedder"),
    (r"\.norm1\.linear\.", ".norm1_linear."),
    (r"\.norm1_context\.linear\.", ".norm1_context_linear."),
    (r"\.norm\.linear\.", ".norm_linear."),
    (r"^norm_out\.linear\.", "norm_out_linear."),
    (r"\.attn\.to_q\.", ".attn_to_q."),
    (r"\.attn\.to_k\.", ".attn_to_k."),
    (r"\.attn\.to_v\.", ".attn_to_v."),
    (r"\.attn\.add_q_proj\.", ".attn_add_q."),
    (r"\.attn\.add_k_proj\.", ".attn_add_k."),
    (r"\.attn\.add_v_proj\.", ".attn_add_v."),
    (r"\.attn\.norm_q\.", ".attn_norm_q."),
    (r"\.attn\.norm_k\.", ".attn_norm_k."),
    (r"\.attn\.norm_added_q\.", ".attn_norm_added_q."),
    (r"\.attn\.norm_added_k\.", ".attn_norm_added_k."),
    (r"\.attn\.to_out\.0\.", ".attn_to_out_0."),
    (r"\.attn\.to_add_out\.", ".attn_to_add_out."),
    (r"\.ff\.net\.0\.proj\.", ".ff_net_0_proj."),
    (r"\.ff\.net\.2\.", ".ff_net_2."),
    (r"\.ff_context\.net\.0\.proj\.", ".ff_context_net_0_proj."),
    (r"\.ff_context\.net\.2\.", ".ff_context_net_2."),
)
# SD3's MMDiT (diffusers SD3Transformer2DModel): FLUX's block names, and the
# patch embedding's convolution and position table under pos_embed
SD3_RENAMES = (
    (r"^pos_embed\.proj\.", "pos_embed_proj."),
    (r"^pos_embed\.pos_embed$", "pos_embed"),
) + FLUX_RENAMES
T5_RENAMES = (  # consolver_tpu/models/t5.py:156-170
    (r"^encoder\.block\.0\.layer\.0\.SelfAttention\.relative_attention_bias\.",
     "relative_attention_bias."),
    (r"^encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.", r"block.\1.attention."),
    (r"^encoder\.block\.(\d+)\.layer\.0\.layer_norm\.", r"block.\1.ln_attn."),
    (r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.wi_0\.", r"block.\1.wi_0."),
    (r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.wi_1\.", r"block.\1.wi_1."),
    (r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.wo\.", r"block.\1.wo."),
    (r"^encoder\.block\.(\d+)\.layer\.1\.layer_norm\.", r"block.\1.ln_ff."),
    (r"^encoder\.final_layer_norm\.", "final_layer_norm."),
    (r"^shared\.", "shared."),
)
# the reference model.ckpt: nn.Sequential layers 0/2/4 (factor_net_ppo.py:75-81)
FACTOR_NET_RENAMES = ((r"^mlp\.0\.", "fc0."), (r"^mlp\.2\.", "fc1."), (r"^mlp\.4\.", "head."))
KIND_RENAMES = {"unet": (), "vae": VAE_ATTN_RENAMES, "clip_text": CLIP_TEXT_RENAMES,
                "clip_text_proj": CLIP_TEXT_RENAMES, "flux": FLUX_RENAMES,
                "sd3_transformer": SD3_RENAMES, "t5": T5_RENAMES,
                "factor_net": FACTOR_NET_RENAMES}
# skip patterns a kind reads: transformers' CLIPTextModelWithProjection (SD3's
# CLIP-L and bigG towers) keeps its text_projection
KIND_KEEPS = {"clip_text_proj": (r"text_projection",)}
# hub keys a kind's converter drops before the walk (convert_inception keeps
# fc), or that no module reads (the first fusion layer of Depth-Anything has
# no residual_layer1 input, transformers keeps its unused weights)
KIND_DROPS = {"inception": ("AuxLogits.",),
              "depth_anything": ("neck.fusion_stage.layers.0.residual_layer1.",)}
KINDS = ("unet", "vae", "clip_text", "clip_vision", "dinov2", "t5", "flux", "factor_net",
         "depth_anything", "segformer", "inception", "sd3_transformer", "clip_text_proj")


# the port's module keys -> hub keys, for the kinds whose names differ (the
# inverse of the renames above; the others keep the hub's names)
TO_HUB = {
    "clip_text": (
        (r"^token_embedding\.", "text_model.embeddings.token_embedding."),
        (r"^position_embedding\.", "text_model.embeddings.position_embedding."),
        (r"^layers\.", "text_model.encoder.layers."),
        (r"\.mlp_fc1\.", ".mlp.fc1."),
        (r"\.mlp_fc2\.", ".mlp.fc2."),
        (r"^final_layer_norm\.", "text_model.final_layer_norm."),
    ),
    "flux": tuple((r"^" + name + r"\.", f"time_text_embed.{name}.") for name in (
        "timestep_embedder", "guidance_embedder", "text_embedder")) + tuple(
        (r"\." + ours + r"\.", "." + theirs + ".") for ours, theirs in (
            ("norm1_linear", "norm1.linear"), ("norm1_context_linear", "norm1_context.linear"),
            ("norm_linear", "norm.linear"), ("attn_to_q", "attn.to_q"),
            ("attn_to_k", "attn.to_k"), ("attn_to_v", "attn.to_v"),
            ("attn_add_q", "attn.add_q_proj"), ("attn_add_k", "attn.add_k_proj"),
            ("attn_add_v", "attn.add_v_proj"), ("attn_norm_q", "attn.norm_q"),
            ("attn_norm_k", "attn.norm_k"), ("attn_norm_added_q", "attn.norm_added_q"),
            ("attn_norm_added_k", "attn.norm_added_k"), ("attn_to_out_0", "attn.to_out.0"),
            ("attn_to_add_out", "attn.to_add_out"), ("ff_net_0_proj", "ff.net.0.proj"),
            ("ff_net_2", "ff.net.2"), ("ff_context_net_0_proj", "ff_context.net.0.proj"),
            ("ff_context_net_2", "ff_context.net.2"))) + (
        (r"^norm_out_linear\.", "norm_out.linear."),),
    "sd3_transformer": (
        (r"^pos_embed_proj\.", "pos_embed.proj."),
        (r"^pos_embed$", "pos_embed.pos_embed"),
    ),
    "t5": (
        (r"^relative_attention_bias\.", "encoder.block.0.layer.0.SelfAttention."
                                        "relative_attention_bias."),
        (r"^block\.(\d+)\.attention\.", r"encoder.block.\1.layer.0.SelfAttention."),
        (r"^block\.(\d+)\.ln_attn\.", r"encoder.block.\1.layer.0.layer_norm."),
        (r"^block\.(\d+)\.(wi_0|wi_1|wo)\.", r"encoder.block.\1.layer.1.DenseReluDense.\2."),
        (r"^block\.(\d+)\.ln_ff\.", r"encoder.block.\1.layer.1.layer_norm."),
        (r"^final_layer_norm\.", "encoder.final_layer_norm."),
    ),
    "factor_net": ((r"^fc0\.", "mlp.0."), (r"^fc1\.", "mlp.2."), (r"^head\.", "mlp.4.")),
}
TO_HUB["sd3_transformer"] += TO_HUB["flux"]
TO_HUB["clip_text_proj"] = TO_HUB["clip_text"]


def hub_state_dict(module_or_state, kind: str) -> Dict[str, torch.Tensor]:
    """A port module's state dict under the hub's key names (diffusers' /
    transformers' / torchvision's / the reference's), as a published
    checkpoint of ``kind`` stores it: the inverse of :func:`hub_key_map`."""
    state = (module_or_state.state_dict() if isinstance(module_or_state, nn.Module)
             else module_or_state)
    out = {}
    for key, value in state.items():
        for pattern, repl in TO_HUB.get(kind, ()):
            key = re.sub(pattern, repl, key)
        out[key] = value
    return out


def hub_jax_path(key: str, ndim: int, renames) -> Tuple[str, ...]:
    """The JAX tree path that the JAX converter gives hub ``key`` (a tensor
    of ``ndim`` dimensions): the renames, merged list indices and the leaf
    rule (``weight`` -> ``embedding`` under an embedding table, ``kernel``
    at 2 or 4 dimensions, ``scale`` at 1)."""
    for pattern, repl in renames:
        key = re.sub(pattern, repl, key)
    *prefix, leaf = _canonical(key).split(".")
    if leaf == "weight":
        if prefix and prefix[-1] in EMBED_PARENTS:
            leaf = "embedding"
        elif ndim in (2, 4):
            leaf = "kernel"
        elif ndim == 1:
            leaf = "scale"
        else:
            raise ValueError(f"Unexpected weight ndim {ndim} at {key}")
    if prefix == ["relative_attention_bias"] and leaf == "kernel":  # T5's bias table
        leaf = "embedding"
    return (*prefix, leaf)


def _skipped(kind: str, key: str) -> bool:
    keeps = KIND_KEEPS.get(kind, ())
    return (any(re.search(p, key) for p in SKIP_PATTERNS if p not in keeps)
            or key.startswith(KIND_DROPS.get(kind, ())))


def hub_key_map(module: nn.Module, kind: str, shapes: Dict[str, Sequence[int]],
                drop: Sequence[str] = ()) -> Dict[str, str]:
    """``{hub key: module key}`` for a hub checkpoint of ``kind`` whose
    tensors have ``shapes``; keys the converter skips, and keys starting
    with a prefix in ``drop``, are left out.  Raises ``KeyError`` naming
    the hub keys with no parameter and the parameters with no hub key."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    own = [k for k in module.state_dict() if not k.endswith("num_batches_tracked")]
    renamed = hasattr(module, "jax_renames")
    renames = module.jax_renames if renamed else KIND_RENAMES[kind]
    if renamed:
        index = {jax_path(k, len(module.state_dict()[k].shape), renames): k for k in own}
    else:
        index = {_canonical(k): k for k in own}
    mapping, extra = {}, []
    for key, shape in shapes.items():
        if _skipped(kind, key) or key.startswith(tuple(drop)):
            continue
        path = hub_jax_path(key, len(shape), renames)
        if not renamed:
            *prefix, leaf = path
            path = _canonical(".".join((*prefix, "weight" if leaf in (
                "kernel", "scale", "embedding") else leaf)))
        target = index.get(path)
        if target is None:
            extra.append(key)
        else:
            mapping[key] = target
    missing = sorted(set(own) - set(mapping.values()))
    if extra or missing:
        raise KeyError(f"{kind} checkpoint does not fit {type(module).__name__}: hub keys with "
                       f"no parameter {sorted(extra)[:8]} ({len(extra)}), parameters with no "
                       f"hub key {missing[:8]} ({len(missing)})")
    return mapping


# ---------------------------------------------------------------------------
# filling a module
# ---------------------------------------------------------------------------


def _fill(module: nn.Module, files, mapping: Callable[[str], Optional[str]], device,
          verbatim: bool) -> nn.Module:
    """Fill ``module`` (on ``meta`` or not) from ``files`` one file at a time:
    ``mapping(file key)`` names the module key (None skips it)."""
    device = torch.device(device)
    own = module.state_dict()
    for f in files:
        part = {}
        for key in f.keys():
            target = mapping(key)
            if target is None:
                continue
            want = own[target]
            src = f.get(key)
            if src.numel() != want.numel():
                raise ValueError(f"{key}: {list(src.shape)} does not fit {target} "
                                 f"{list(want.shape)}")
            value = src.reshape(want.shape).to(device)
            if not verbatim:
                value = cast_floating(value, want.dtype)
            if value.data_ptr() == src.data_ptr():  # still the file's pages
                value = value.clone()
            part[target] = value
            del src  # its mapping goes with it
        module.load_state_dict(part, strict=False, assign=True)
    for name, t in module.state_dict().items():
        if t.is_meta:
            if not name.endswith("num_batches_tracked"):
                raise KeyError(f"{name} was not in the checkpoint")
            module.load_state_dict({name: torch.zeros((), dtype=t.dtype, device=device)},
                                   strict=False, assign=True)
    return module


def load_hub(module: nn.Module, kind: str, src: str, device=None,
             drop: Sequence[str] = ()) -> nn.Module:
    """Fill ``module`` from a hub checkpoint of ``kind`` under ``src`` (each
    tensor in the dtype of the module's tensor, on ``device``, default the
    module's own device)."""
    files = open_files(src)
    shapes = {k: f.shape(k) for f in files for k in f.keys()}
    mapping = hub_key_map(module, kind, shapes, drop)
    return _fill(module, files, mapping.get, _device(module, device), verbatim=False)


def load_component(module: nn.Module, path: str, device=None, verbatim: bool = False,
                   drop: Sequence[str] = ()) -> nn.Module:
    """Fill ``module`` from a port component directory (its own keys,
    strictly: a key the module lacks, or a parameter the files lack,
    raises); ``verbatim`` keeps the files' dtypes; keys starting with a
    prefix in ``drop`` are skipped."""
    files = open_files(path)
    own = set(module.state_dict())
    keys = {k for f in files for k in f.keys() if not k.startswith(tuple(drop))}
    if keys - own:
        raise KeyError(f"{path}: keys {sorted(keys - own)[:8]} are not in "
                       f"{type(module).__name__}")
    return _fill(module, files, lambda k: k if k in keys else None,
                 _device(module, device), verbatim)


def _device(module: nn.Module, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    t = next(iter(module.state_dict().values()))
    if t.is_meta:
        raise ValueError("a module on meta needs the device to load onto")
    return t.device


def save_component(module_or_state, path: str, config=None) -> List[str]:
    """Write a component directory: the state dict as ``model.safetensors``
    in ``path`` and, with ``config``, its dataclass as
    ``{path}_config.json``; returns the weight files."""
    state = (module_or_state.state_dict() if isinstance(module_or_state, nn.Module)
             else module_or_state)
    files = save_sharded(state, path, metadata={"format": "pt"})
    if config is not None:
        write_config(path, config)
    return files


# ---------------------------------------------------------------------------
# config sidecars
# ---------------------------------------------------------------------------


def config_path(path: str) -> str:
    return path.rstrip("/") + "_config.json"


def write_config(path: str, config) -> str:
    """``{path}_config.json``: the dataclass's fields (tuples as lists)."""
    out = config_path(path)
    with open(out, "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2)
    return out


def config_from_dict(cls, raw: Dict[str, Any]):
    """``cls(**raw)`` with JSON's lists back as tuples and nested
    dataclasses rebuilt from their dicts."""
    hints = typing.get_type_hints(cls)
    fields = {}
    for name, value in raw.items():
        typ = hints.get(name)
        if isinstance(value, dict) and dataclasses.is_dataclass(typ):
            value = config_from_dict(typ, value)
        elif isinstance(value, list):
            value = _tuples(value)
        fields[name] = value
    return cls(**fields)


def _tuples(value):
    return tuple(_tuples(v) for v in value) if isinstance(value, list) else value


def load_model_config(path: str, cls, default):
    """The config in ``{path}_config.json`` (as the JAX converter and
    ``quantize_checkpoint.py`` write it), else ``default``."""
    sidecar = config_path(path)
    if not os.path.exists(sidecar):
        return default
    with open(sidecar) as f:
        return config_from_dict(cls, json.load(f))


def is_quantized(config) -> bool:
    return bool(getattr(config, "quant_int8", False) or getattr(config, "quant_int4", False))


# ---------------------------------------------------------------------------
# the kinds' modules
# ---------------------------------------------------------------------------


def kind_spec(kind: str):
    """``(config class, default config)`` of a checkpoint kind (``(None,
    None)`` for InceptionV3, which has no config)."""
    from consolver_torch.models.clip_text import ClipTextConfig, ClipTextProjConfig
    from consolver_torch.models.depth_anything import DepthAnythingConfig
    from consolver_torch.models.flux import FluxConfig
    from consolver_torch.models.mmdit import MMDiTConfig
    from consolver_torch.models.segformer import SegformerConfig
    from consolver_torch.models.t5 import T5Config
    from consolver_torch.models.unet_2d import UNetConfig
    from consolver_torch.models.vae import VaeConfig
    from consolver_torch.models.vit import ViTConfig
    from consolver_torch.policy.factor_net import FactorNetConfig

    specs = {
        "unet": (UNetConfig, UNetConfig.sd15()),
        "vae": (VaeConfig, VaeConfig.sd15()),
        "clip_text": (ClipTextConfig, ClipTextConfig.sd15()),
        "t5": (T5Config, T5Config.xxl()),
        "flux": (FluxConfig, FluxConfig.flux_kontext()),
        "sd3_transformer": (MMDiTConfig, MMDiTConfig.sd35_large()),
        "clip_text_proj": (ClipTextProjConfig, ClipTextProjConfig.openclip_bigg()),
        "clip_vision": (ViTConfig, ViTConfig.clip_vit_l14()),
        "dinov2": (ViTConfig, ViTConfig.dinov2_base()),
        "depth_anything": (DepthAnythingConfig, DepthAnythingConfig.small_v2()),
        "segformer": (SegformerConfig, SegformerConfig.b4_ade()),
        "inception": (None, None),
        "factor_net": (FactorNetConfig, FactorNetConfig()),
    }
    if kind not in specs:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    return specs[kind]


def build_module(kind: str, config, device, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The module of ``kind`` at ``config``, on ``meta`` for a loader to
    fill; the FactorNet (whose action grid is a computed buffer) is built on
    ``device`` itself.  InceptionV3 keeps its 1000-class head (the reward
    configuration, as ``convert_inception(keep_fc=True)``)."""
    from consolver_torch.models.clip_text import ClipTextEncoder
    from consolver_torch.models.depth_anything import DepthAnything
    from consolver_torch.models.flux import FluxTransformer
    from consolver_torch.models.inception import InceptionV3
    from consolver_torch.models.mmdit import SD3Transformer
    from consolver_torch.models.segformer import Segformer
    from consolver_torch.models.t5 import T5Encoder
    from consolver_torch.models.unet_2d import UNet2DCondition
    from consolver_torch.models.vae import AutoencoderKL
    from consolver_torch.models.vit import ViT
    from consolver_torch.policy.factor_net import FactorNet

    if kind == "factor_net":
        return FactorNet(config, device=device)
    if kind == "inception":
        return InceptionV3(1000, device="meta", dtype=dtype)
    cls = {"unet": UNet2DCondition, "vae": AutoencoderKL, "clip_text": ClipTextEncoder,
           "clip_text_proj": ClipTextEncoder, "t5": T5Encoder, "flux": FluxTransformer,
           "sd3_transformer": SD3Transformer, "clip_vision": ViT, "dinov2": ViT,
           "depth_anything": DepthAnything, "segformer": Segformer}[kind]
    return cls(config, device="meta", dtype=dtype)
