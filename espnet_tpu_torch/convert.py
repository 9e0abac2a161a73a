"""Carry JAX parameters into the port.

`jax_params_to_state_dict` turns the param tree of the JAX package's
`ASRModel.init(...)["params"]` (nested dicts of numpy arrays, as a flax
msgpack checkpoint restores them) into a `state_dict` of
`espnet_tpu_torch.models.asr.ASRModel`. Paths map one to one
("encoder/layer0/ff1/w1/kernel" -> "encoder.layer0.ff1.w1.weight"); the
leaves change layout:

* Dense `kernel` (in, out) -> `nn.Linear.weight` (out, in);
* Conv2d `kernel` (kh, kw, in, out), NHWC -> (out, in, kh, kw);
* depthwise Conv1d `kernel` (k, 1, d) -> (d, 1, k);
* LayerNorm `scale` -> `weight` (eps 1e-6 is set by the port's LayerNorm);
* Embed `embedding` -> `weight`;
* Conv1d `kernel` (k, in, out) -> (out, in, k) (the depthwise (k, 1, d)
  among them), Conv2d's as above (the VGG front and AttLoc2D);
* `pos_bias_u` / `pos_bias_v` (H, dk), every `bias`, and the raw
  parameters of the S4 layer (`log_neg_a_re`, `a_im`, `log_dt`, `c_re`,
  `c_im`, `d`), the sinc filters (`low_hz`, `band_hz`), the multi-head
  RNN attentions (`gvec`, (H, dk)), the S3PRL featurizer's
  `layer_weights`, HuBERT's `mask_emb` and Whisper's `positions` tables
  as they are.

The fused and unfused JAX layers use the same param names, so one mapping
serves both. A conformer built with `scan_encoder_layers=True` keeps its
blocks as one `encoder/block` of stacked (L, ...) leaves; the port's
encoder is unrolled, so leaf i of the stack becomes `encoder.layer{i}`. A
leaf that the port's model has no place for is refused.

A global-MVN model keeps its feature statistics in the non-trainable JAX
collection `mvn` ({"mvn": {"mvn": {"mean", "inv_std"}}}): pass the whole
variables dict {"params": ..., "mvn": ...} and they become the buffers
`mvn.mean` and `mvn.inv_std`. Loading such a model from its params alone
raises, since identity statistics would silently change its input.

Every layout change is a permutation, so the same mapping carries a JAX
*gradient* tree (`jax.grad` of the params) onto the port's parameter names
with `jax_params_to_state_dict`, to be compared with `param.grad` leaf by
leaf; `torch_to_jax_tree` maps the port's tensors (parameters after an
update, or their gradients) back into the nested layout of a given JAX tree.

`state_dict_to_jax_params` is the inverse that needs no JAX tree to fill (the
card's machine has none): each port leaf's JAX name and layout follow from
its name, rank and owner (`weight` of rank 1 is a LayerNorm `scale`, of an
`embed` module an `embedding`, else a `kernel` in the JAX layout). It gives
the param tree that the JAX package saves as `ep<N>.params.msgpack`; the
global-MVN buffers, which JAX keeps in its `mvn` collection, are left out.
With `scan_layers` (a conformer built with `scan_encoder_layers`) the
encoder's layers are stacked back into `encoder/block`, the tree JAX saves
for such a model.

The MT and ST trees (`models/mt.py`, `models/st.py`) need no rule of their
own either: the source embedding is `encoder/embed/embedding`, the MT
encoder's layers `encoder/layer{i}` and its final norm
`encoder/after_norm`, the CTC head over the source vocabulary `ctc_head`,
the source-side decoder `asr_decoder`, and an ST model with global MVN
keeps its statistics in the `mvn` collection, as the ASR model does.

The SSL and Whisper trees (`models/ssl.py`) and HuBERT's
(`models/hubert.py`) follow the same rules: the S3PRL frontend is
`ssl_frontend/upstream/...` beside its raw `ssl_frontend/layer_weights`,
the wav2vec2 encoder `encoder/upstream/...` and `encoder/output_layer`,
the trunk's grouped `pos_conv` a Conv kernel (k, in/groups, out) and its
GroupNorm a `scale`; Whisper's `encoder/positions` and `decoder/positions`
are raw tables and `decoder/embed_tokens/embedding` an embedding; HuBERT's
`mask_emb` is raw, its `layer{i}` the transformer's encoder layers.

The transducer's tree (`models/transducer.py`) follows the same rules: its
LSTM cells are Dense layers named as flax's `OptimizedLSTMCell` names its
kernels (`decoder/lstm{i}/{ii,if,ig,io}/kernel`, `decoder/lstm{i}/{hi,hf,hg,
ho}/{kernel,bias}`), its embedding is `decoder/embed/embedding` and the
joint's layers `joint/lin_{enc,dec,out}`, so no leaf needs a rule of its
own. So do the v1 RNN models' and the beamformer's cells, which the JAX
`nn.RNN` calls leave under flax's automatic names
(`encoder/OptimizedLSTMCell_{k}`, `frontend_beamformer/mask_est/
OptimizedLSTMCell_{k}`): the port's modules carry the same names.

The TTS trees (`models/tts/`: Tacotron2, FastSpeech2, Transformer-TTS,
ProDiff, GST, the speaker conditioner and extractor, VC) add three things.
Tacotron2's encoder BLSTM cells are `OptimizedLSTMCell_{0,1}` under the
encoder and its decoder cells `decoder/lstm{i}` (flax's cell, as above);
GST's GRU is flax's `GRUCell` (`gst/ref_enc/GRUCell_0/{ir,iz,in,hr,hz,hn}`,
Dense layers of the same names in the port); `tokens` (GST) and `pos_alpha`
(FastSpeech2's scaled positions) are raw leaves, and `sid_emb` / `lid_emb`
embedding tables. BatchNorm (Tacotron2's encoder, the postnet) keeps its
running `mean` and `var` in the JAX `batch_stats` collection: a variables
dict {"params", "batch_stats", "mvn"} carries them to the BatchNorm
buffers of the same path, and `model_variables` gives the port's
parameters and running statistics back as such a dict. A param tree
without `batch_stats` (the JAX package's `ep<N>.params.msgpack`) leaves
the model's running statistics as they are, as the JAX package's TTS
inference starts from the initial ones (ROADMAP.md queue 3).

The enhancement trees (`models/enh/`) add raw leaves: flax's PReLU slope
`negative_slope` (a scalar), gLN and cLN's `gamma` / `beta`, DAN's
`attractor_init`, DCCRN's transposed-conv `kernel_r`, `kernel_i`,
`bias_r`, `bias_i` and iNeuBe's `last_kernel`, `last_bias`,
`norm_scale`, `norm_bias` (the 4-D ones in flax's (kh, kw, in, out)
layout, which the modules read as it is). A flax transposed conv's kernel
(k, in, out) becomes (out, in, k) as every 3-D kernel; the port's
`ConvTranspose1d` flips it. DC-CRN's and DCCRN's BatchNorm statistics are
the `batch_stats` collection, as TTS's.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


# raw parameters carried without a layout change
RAW_LEAVES = ("bias", "pos_bias_u", "pos_bias_v", "log_neg_a_re", "a_im",
              "log_dt", "c_re", "c_im", "d", "low_hz", "band_hz", "gvec",
              "layer_weights", "mask_emb", "positions", "tokens", "pos_alpha",
              "negative_slope", "gamma", "beta", "attractor_init",
              "kernel_r", "kernel_i", "bias_r", "bias_i", "last_kernel",
              "last_bias", "norm_scale", "norm_bias")
# modules whose 2-D `weight` is an embedding table
EMBEDDINGS = ("embed", "embed_tokens", "sid_emb", "lid_emb", "global_emb",
              "lang_emb")
COLLECTIONS = ("params", "mvn", "batch_stats")


def _leaf(name: str, value: np.ndarray):
    """(torch leaf name, array in torch layout) for one JAX leaf."""
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 3:
            return "weight", value.transpose(2, 1, 0)
        raise ValueError(f"kernel of unexpected rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    if name in RAW_LEAVES:
        return name, value
    raise ValueError(f"unknown parameter leaf {name!r}")


SCAN_PREFIX = "encoder/block/"


def _unstack_scan(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The stacked `encoder/block` leaves of a scan_layers tree as the
    unrolled `encoder/layer{i}` leaves (the layer axis is the first)."""
    out = {}
    for path, value in flat.items():
        if not path.startswith(SCAN_PREFIX):
            out[path] = value
            continue
        rest = path[len(SCAN_PREFIX):]
        for i in range(value.shape[0]):
            out[f"encoder/layer{i}/{rest}"] = value[i]
    return out


def _stack_scan(tree: Dict[str, Dict]) -> Dict[str, Dict]:
    """The inverse of `_unstack_scan` on a nested tree: the encoder's
    `layer{i}` subtrees stacked into one `block`, in its place."""
    enc = tree["encoder"]
    layers = [k for k in enc if k.startswith("layer")]
    if not layers:
        raise ValueError("scan_layers: the encoder has no layer{i}")
    subtrees = [enc[f"layer{i}"] for i in range(len(layers))]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.ascontiguousarray(np.stack(xs))

    out = {}
    for key, value in enc.items():
        if key == "layer0":
            out["block"] = stack(*subtrees)
        elif key not in layers:
            out[key] = value
    return {k: (out if k == "encoder" else v) for k, v in tree.items()}


def _split_variables(tree: Mapping):
    """(params, mvn collection or None, batch_stats collection or None) of
    a JAX param tree or of a variables dict {"params", optionally "mvn" and
    "batch_stats"}."""
    if "params" in tree and set(tree) <= set(COLLECTIONS):
        return tree["params"], tree.get("mvn"), tree.get("batch_stats")
    return tree, None, None


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a JAX `ASRModel` param tree, or its variables dict with the `mvn`
    and `batch_stats` collections, to the port's state_dict (float32)."""
    params, mvn, stats = _split_variables(params)
    sd = {}
    for path, value in list(_flatten(mvn or {}).items()) + list(
            _flatten(stats or {}).items()):
        sd[path.replace("/", ".")] = torch.from_numpy(
            np.array(value, np.float32))
    for path, value in _unstack_scan(_flatten(params)).items():
        parts = path.split("/")
        leaf, arr = _leaf(parts[-1], value)
        key = ".".join(parts[:-1] + [leaf])
        if key in sd:
            raise ValueError(f"two JAX leaves map to {key}")
        sd[key] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def _unleaf(name: str, value: np.ndarray) -> np.ndarray:
    """The inverse of `_leaf`'s layout change for JAX leaf `name`."""
    if name == "kernel":
        if value.ndim == 2:
            return value.T
        if value.ndim == 4:
            return value.transpose(2, 3, 1, 0)
        if value.ndim == 3:
            return value.transpose(2, 1, 0)
    return value


def torch_to_jax_tree(tensors: Mapping[str, torch.Tensor],
                      like: Mapping) -> Dict:
    """Nested dict with `like`'s structure (a JAX param tree), each leaf
    taken from `tensors` (port names -> tensors, e.g. a state_dict or the
    parameters' gradients) in the JAX layout, as float32 numpy arrays."""
    if "params" in like and set(like) <= set(COLLECTIONS):
        like = like["params"]

    def build(tree, prefix):
        out = {}
        for key, value in tree.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                out[key] = build(value, path)
                continue
            parts = path.split("/")
            leaf, _ = _leaf(parts[-1], np.asarray(value))
            t = tensors[".".join(parts[:-1] + [leaf])]
            arr = t.detach().cpu().float().numpy()
            out[key] = np.array(_unleaf(parts[-1], arr), order="C")
        return out

    return build(like, "")


MVN_BUFFERS = ("mvn.mean", "mvn.inv_std")
BATCH_STAT_LEAVES = (".mean", ".var")  # BatchNorm's running buffers


def _jax_leaf(key: str, value: np.ndarray, has_bias: bool = False):
    """(JAX leaf name, array in the JAX layout) of the port's leaf `key`;
    `has_bias`: its module also has a bias (a Dense named like an
    embedding table, as the speaker extractor's `embed`)."""
    parts = key.split(".")
    name = parts[-1]
    if name in RAW_LEAVES:
        return name, value
    if name != "weight":
        raise ValueError(f"unknown parameter leaf {key!r}")
    if value.ndim == 1:
        return "scale", value
    if value.ndim == 2 and len(parts) > 1 and parts[-2] in EMBEDDINGS \
            and not has_bias:
        return "embedding", value
    if value.ndim in (2, 3, 4):
        return "kernel", _unleaf("kernel", value)
    raise ValueError(f"{key}: weight of unexpected rank {value.ndim}")


def state_dict_to_jax_params(state_dict: Mapping[str, torch.Tensor],
                             scan_layers: bool = False) -> Dict[str, Dict]:
    """The JAX param tree (nested dicts of float32 numpy arrays, in the
    port's module order) of the port's `state_dict`: the inverse of
    `jax_params_to_state_dict` on a param tree. The global-MVN buffers are
    left out (the JAX `mvn` collection is not a param). `scan_layers`
    stacks the encoder's layers into the `encoder/block` of a JAX model
    built with scan_encoder_layers=True."""
    tree: Dict[str, Dict] = {}
    for key, t in state_dict.items():
        if key in MVN_BUFFERS or key.endswith(BATCH_STAT_LEAVES):
            continue
        arr = (t.detach().cpu().float().numpy()
               if isinstance(t, torch.Tensor) else np.asarray(t, np.float32))
        leaf, arr = _jax_leaf(key, arr, key[:-len("weight")] + "bias"
                              in state_dict)
        cur = tree
        for p in key.split(".")[:-1]:
            cur = cur.setdefault(p, {})
        if leaf in cur:
            raise ValueError(f"two port leaves map to {key}")
        # np.array, not ascontiguousarray: it keeps a scalar's shape ()
        cur[leaf] = np.array(arr, dtype=np.float32, order="C")
    return _stack_scan(tree) if scan_layers else tree


def batch_stats_tree(model: torch.nn.Module) -> Dict[str, Dict]:
    """The JAX `batch_stats` collection of `model`'s BatchNorm buffers
    (nested dicts of float32 numpy arrays; empty without BatchNorm)."""
    from espnet_tpu_torch.models.layers import BatchNorm

    tree: Dict[str, Dict] = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, BatchNorm):
            continue
        cur = tree
        for p in name.split("."):
            cur = cur.setdefault(p, {})
        for leaf in ("mean", "var"):
            cur[leaf] = getattr(mod, leaf).detach().cpu().float().numpy()
    return tree


def model_variables(model: torch.nn.Module) -> Dict[str, Dict]:
    """{"params": the JAX param tree, "batch_stats": ...} of `model` (the
    second only where it has BatchNorm): what flax's `apply` takes."""
    out = {"params": model_params(model)}
    stats = batch_stats_tree(model)
    if stats:
        out["batch_stats"] = stats
    return out


def batch_stat_keys(model: torch.nn.Module) -> set:
    """The state_dict keys of `model`'s BatchNorm running buffers."""
    from espnet_tpu_torch.models.layers import BatchNorm

    return {f"{name}.{leaf}" for name, mod in model.named_modules()
            if isinstance(mod, BatchNorm) for leaf in ("mean", "var")}


def model_params(model: torch.nn.Module) -> Dict[str, Dict]:
    """The JAX param tree of `model`, stacked where its encoder says
    `scan_layers` (only the conformer takes the flag, as in the JAX
    package, which saves the other encoders unrolled)."""
    encoder = getattr(model, "encoder", None)
    return state_dict_to_jax_params(
        model.state_dict(),
        scan_layers=bool(getattr(encoder, "scan_layers", False)))


def load_jax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load a JAX param tree, or the variables dict {"params", "mvn",
    "batch_stats"}, into `model`; raises on any key left unused on either
    side (but the BatchNorm running statistics that the tree lacks: they
    stay as they are), or on a shape that does not match. The transducer and Mask-CTC
    drop the `mvn` collection: they have no global-MVN buffers, and the JAX
    models never read the stats that their tasks pass them."""
    from espnet_tpu_torch.models.maskctc import MaskCTCModel
    from espnet_tpu_torch.models.transducer import TransducerASRModel

    tree, mvn, _ = _split_variables(params)
    if mvn is not None and isinstance(model, (TransducerASRModel,
                                              MaskCTCModel)):
        params = tree
    sd = jax_params_to_state_dict(params)
    own = model.state_dict()
    unused = sorted(set(sd) - set(own))
    # running statistics the tree lacks stay as they are
    missing = sorted(set(own) - set(sd) - batch_stat_keys(model))
    if any(k.startswith("mvn.") for k in missing):
        raise KeyError(
            "the model normalises with global MVN, but no 'mvn' statistics "
            "came with the parameters: pass the JAX variables dict "
            "{'params': ..., 'mvn': ...}")
    if unused or missing:
        raise KeyError(f"JAX params unused by the port: {unused}; "
                       f"port params missing from the JAX tree: {missing}")
    for key, value in sd.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: JAX shape {tuple(value.shape)} vs port "
                             f"{tuple(own[key].shape)}")
    model.load_state_dict(sd, strict=False)
    return model


# --- GAN training states ---------------------------------------------------

def _flat_by_name(module: torch.nn.Module, flat: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """A flat vector laid out as `train/optim.py` `flatten_parameters_`
    lays out `module`'s parameters, cut back into {name: tensor}."""
    out, off = {}, 0
    for name, p in module.named_parameters():
        out[name] = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return out


def _adam_tree(module, opt_state) -> Dict:
    """optax chain(clip_by_global_norm, adam)'s state as flax's
    `to_state_dict` writes it: ({}, ({count, mu, nu}, {}))."""
    return {"0": {}, "1": {"0": {
        "count": np.asarray(int(opt_state["count"]), np.int32),
        "mu": state_dict_to_jax_params(_flat_by_name(module,
                                                     opt_state["mu"])),
        "nu": state_dict_to_jax_params(_flat_by_name(module,
                                                     opt_state["nu"]))},
        "1": {}}}


def gan_state_to_jax(state) -> Dict:
    """The state dict of the JAX package's `GANTrainState` (flax's
    `to_state_dict` layout; `serialization.from_bytes` of a
    `GANTrainState.create(...)` restores its msgpack) of a port
    `train/gan_steps.py` `GANTrainState` with `FlatAdam` optimizers. JAX's
    PRNG key has no counterpart in the port's generator: it is written as
    (0, 0)."""
    return {"step": np.asarray(state.step, np.int32),
            "gen_params": model_params(state.generator),
            "gen_opt": _adam_tree(state.generator, state.gen_state),
            "disc_params": model_params(state.discriminator),
            "disc_opt": _adam_tree(state.discriminator, state.disc_state),
            "rng": np.zeros(2, np.uint32)}


def _load_adam(module, opt_state, tree) -> None:
    adam = tree["1"]["0"]
    for slot in ("mu", "nu"):
        by_name = jax_params_to_state_dict(adam[slot])
        opt_state[slot].copy_(torch.cat([
            by_name[name].reshape(-1) for name, _ in
            module.named_parameters()]).to(opt_state[slot].device))
    opt_state["count"].fill_(int(np.asarray(adam["count"])))


@torch.no_grad()
def load_jax_gan_state(state, tree: Mapping) -> None:
    """Load the state dict of a JAX `GANTrainState` (`gan_state_to_jax`'s
    layout, e.g. flax's `to_state_dict` or the msgpack of its bytes) into
    a port `GANTrainState`, in place: both modules' parameters, both Adam
    states and the step; the port's generator of draws stays as it is."""
    load_jax_params(state.generator, tree["gen_params"])
    load_jax_params(state.discriminator, tree["disc_params"])
    _load_adam(state.generator, state.gen_state, tree["gen_opt"])
    _load_adam(state.discriminator, state.disc_state, tree["disc_opt"])
    state.step = int(np.asarray(tree["step"]))
