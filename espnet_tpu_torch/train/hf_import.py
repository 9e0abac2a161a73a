"""HuggingFace wav2vec2 / HuBERT / Whisper checkpoints -> the JAX package's
param trees for `models/ssl.py` (port of espnet_tpu/train/hf_import.py).

Numpy on a `state_dict`-style mapping (torch tensors or numpy arrays), so
it works on `torch.load`-ed files, on `.safetensors` files and on live
models. The trees are the JAX package's (flax layouts), which
`convert.jax_params_to_state_dict` carries into the port and
`train/pretrained.py` transfers with `--run.init_param`:

* torch Linear (out, in) -> Dense kernel (in, out);
* torch Conv1d (out, in/groups, k) -> Conv kernel (k, in/groups, out);
* torch weight norm (dim 2; the parametrization keys `original0` = g and
  `original1` = v, or the legacy `weight_g` / `weight_v`) collapsed to the
  kernel w = g v / ||v|| over dims 0 and 1;
* LayerNorm / GroupNorm weight, bias -> scale, bias.

`load_torch_state_dict` reads `.bin` / `.pt` with `torch.load(...,
weights_only=True)` and `.safetensors` with the port's own reader
(`read_safetensors`: an 8-byte little-endian header length, a JSON header
of dtype, shape and byte offsets, then the raw little-endian buffers;
F32, F16 and BF16, returned as float32 for BF16), since the card's
machine has no `safetensors` package.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np

from espnet_tpu_torch.models.ssl import SSLConfig, WhisperConfig


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _dense(sd: Mapping, prefix: str, bias: bool = True) -> Dict:
    out = {"kernel": _np(sd[prefix + ".weight"]).T}
    if bias and prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _conv(sd: Mapping, prefix: str) -> Dict:
    out = {"kernel": _np(sd[prefix + ".weight"]).transpose(2, 1, 0)}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _norm(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _np(sd[prefix + ".weight"]),
            "bias": _np(sd[prefix + ".bias"])}


def _weight_norm_conv(sd: Mapping, prefix: str) -> Dict:
    """torch weight_norm (dim 2) collapsed to a plain Conv kernel."""
    if prefix + ".parametrizations.weight.original0" in sd:
        g = _np(sd[prefix + ".parametrizations.weight.original0"])
        v = _np(sd[prefix + ".parametrizations.weight.original1"])
    else:
        g = _np(sd[prefix + ".weight_g"])
        v = _np(sd[prefix + ".weight_v"])
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)  # (out, in/groups, k)
    return {"kernel": w.transpose(2, 1, 0), "bias": _np(sd[prefix + ".bias"])}


def _hf_attention(sd: Mapping, prefix: str, k_bias: bool = True) -> Dict:
    return {
        "q_proj": _dense(sd, prefix + ".q_proj"),
        "k_proj": _dense(sd, prefix + ".k_proj", bias=k_bias),
        "v_proj": _dense(sd, prefix + ".v_proj"),
        "out_proj": _dense(sd, prefix + ".out_proj"),
    }


def wav2vec2_params_from_torch(sd: Mapping, cfg: SSLConfig) -> Dict:
    """HF Wav2Vec2Model / HubertModel state_dict -> the `Wav2Vec2Model`
    tree of geometry `cfg` (`ssl_config_from_hf`)."""
    sd = dict(sd)
    fe: Dict = {}
    for i in range(len(cfg.conv_dim)):
        fe[f"conv{i}"] = _conv(sd, f"feature_extractor.conv_layers.{i}.conv")
        if cfg.feat_extract_norm == "group" and i == 0:
            fe["group_norm"] = _norm(
                sd, "feature_extractor.conv_layers.0.layer_norm")
        elif cfg.feat_extract_norm == "layer":
            fe[f"norm{i}"] = _norm(
                sd, f"feature_extractor.conv_layers.{i}.layer_norm")
    params: Dict = {
        "feature_extractor": fe,
        "projection": _dense(sd, "feature_projection.projection"),
        "pos_conv": _weight_norm_conv(sd, "encoder.pos_conv_embed.conv"),
        "norm": _norm(sd, "encoder.layer_norm"),
    }
    if cfg.feat_proj_layer_norm:
        params["proj_norm"] = _norm(sd, "feature_projection.layer_norm")
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        params[f"layer{i}"] = {
            "attention": _hf_attention(sd, p + ".attention"),
            "layer_norm": _norm(sd, p + ".layer_norm"),
            "intermediate_dense": _dense(
                sd, p + ".feed_forward.intermediate_dense"),
            "output_dense": _dense(sd, p + ".feed_forward.output_dense"),
            "final_layer_norm": _norm(sd, p + ".final_layer_norm"),
        }
    return params


def ssl_config_from_hf(hf_config) -> SSLConfig:
    """An SSLConfig from any object with the attributes of a HF
    Wav2Vec2Config / HubertConfig (a `SimpleNamespace` of config.json)."""
    return SSLConfig(
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        ffn_size=hf_config.intermediate_size,
        conv_dim=tuple(hf_config.conv_dim),
        conv_kernel=tuple(hf_config.conv_kernel),
        conv_stride=tuple(hf_config.conv_stride),
        conv_bias=hf_config.conv_bias,
        feat_extract_norm=hf_config.feat_extract_norm,
        num_conv_pos_embeddings=hf_config.num_conv_pos_embeddings,
        num_conv_pos_embedding_groups=hf_config.num_conv_pos_embedding_groups,
        do_stable_layer_norm=getattr(hf_config, "do_stable_layer_norm",
                                     False),
        feat_proj_layer_norm=getattr(hf_config, "feat_proj_layer_norm", True),
    )


def _whisper_layer(sd: Mapping, prefix: str, cross: bool) -> Dict:
    out = {
        "self_attn": _hf_attention(sd, prefix + ".self_attn", k_bias=False),
        "self_attn_layer_norm": _norm(sd, prefix + ".self_attn_layer_norm"),
        "fc1": _dense(sd, prefix + ".fc1"),
        "fc2": _dense(sd, prefix + ".fc2"),
        "final_layer_norm": _norm(sd, prefix + ".final_layer_norm"),
    }
    if cross:
        out["encoder_attn"] = _hf_attention(
            sd, prefix + ".encoder_attn", k_bias=False)
        out["encoder_attn_layer_norm"] = _norm(
            sd, prefix + ".encoder_attn_layer_norm")
    return out


def whisper_encoder_params_from_torch(sd: Mapping, cfg: WhisperConfig
                                      ) -> Dict:
    """HF WhisperModel state_dict (keys with their `encoder.` prefix) ->
    the `WhisperEncoder` tree."""
    params: Dict = {
        "conv1": _conv(sd, "encoder.conv1"),
        "conv2": _conv(sd, "encoder.conv2"),
        "positions": _np(sd["encoder.embed_positions.weight"]),
        "norm": _norm(sd, "encoder.layer_norm"),
    }
    for i in range(cfg.encoder_layers):
        params[f"layer{i}"] = _whisper_layer(
            sd, f"encoder.layers.{i}", cross=False)
    return params


def whisper_decoder_params_from_torch(sd: Mapping, cfg: WhisperConfig
                                      ) -> Dict:
    """HF WhisperModel state_dict (`decoder.` keys) -> the
    `WhisperDecoder` tree."""
    params: Dict = {
        "embed_tokens": {"embedding": _np(sd["decoder.embed_tokens.weight"])},
        "positions": _np(sd["decoder.embed_positions.weight"]),
        "norm": _norm(sd, "decoder.layer_norm"),
    }
    for i in range(cfg.decoder_layers):
        params[f"layer{i}"] = _whisper_layer(
            sd, f"decoder.layers.{i}", cross=True)
    return params


def whisper_config_from_hf(hf_config) -> WhisperConfig:
    """A WhisperConfig from any object with a HF WhisperConfig's
    attributes."""
    return WhisperConfig(
        vocab_size=hf_config.vocab_size,
        n_mels=hf_config.num_mel_bins,
        d_model=hf_config.d_model,
        encoder_layers=hf_config.encoder_layers,
        decoder_layers=hf_config.decoder_layers,
        num_heads=hf_config.encoder_attention_heads,
        ffn_size=hf_config.encoder_ffn_dim,
        max_source_positions=hf_config.max_source_positions,
        max_target_positions=hf_config.max_target_positions,
    )


# safetensors dtype -> (numpy dtype of the stored bytes, bytes per element)
SAFETENSORS_DTYPES = {"F32": ("<f4", 4), "F16": ("<f2", 2),
                      "BF16": ("<u2", 2)}


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """A `.safetensors` file -> {name: array}: F32 and F16 as stored, BF16
    widened to float32 (numpy has no bfloat16)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}; the reader takes "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        np_dtype, size = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end - start != size * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name}: {end - start} bytes "
                             f"for shape {shape} of {info['dtype']}")
        arr = np.frombuffer(data, np_dtype, (end - start) // size,
                            base + start).reshape(shape)
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.copy()
    return out


def write_safetensors(path, tensors: Mapping[str, np.ndarray]) -> None:
    """{name: float32 or float16 array} -> a `.safetensors` file (the
    format `read_safetensors` reads; keys in sorted order, as the
    `safetensors` package writes them)."""
    codes = {np.dtype("<f4"): "F32", np.dtype("<f2"): "F16"}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        code = codes[arr.dtype.newbyteorder("<")]
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file -> {key: np.ndarray}: `.safetensors` through
    `read_safetensors`, anything else through `torch.load(...,
    weights_only=True)` (a `state_dict` entry, when present, is the
    state dict)."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: _np(v) for k, v in sd.items()}
