"""Convert a HuggingFace wav2vec2 / HuBERT / Whisper checkpoint into a
params msgpack for `--run.init_param` (port of espnet_tpu/bin/convert_hf.py).

    python -m espnet_tpu_torch.bin.convert_hf --model_type wav2vec2 \
        --checkpoint model.safetensors [--config config.json] --out w2v2.msgpack

`--checkpoint` is a `.safetensors`, `.bin` or `.pt` file, or a HF model
directory holding `model.safetensors` or `pytorch_model.bin` and
`config.json` (`--config` defaults to the `config.json` beside the file).
The task heads' prefixes (`wav2vec2.`, `hubert.`, `model.`) are stripped.
Writes the JAX package's tree through the port's msgpack codec
(`{"params": <trunk>}` for wav2vec2 and hubert, `{"encoder", "decoder"}`
for whisper) and the `<out>.json` sidecar {"model_type", "config"}; an ASR
run then takes the subtrees with

    --run.init_param w2v2.msgpack:params:encoder/upstream       (wav2vec2 encoder)
    --run.init_param w2v2.msgpack:params:ssl_frontend/upstream  (S3PRL frontend)
    --run.init_param whisper.msgpack:encoder:encoder            (Whisper)
    --run.init_param whisper.msgpack:decoder:decoder            (its decoder)

Runs on the host (numpy); needs neither `transformers` nor `safetensors`.
"""

from __future__ import annotations

import argparse
import json
import types
from pathlib import Path

PREFIXES = ("wav2vec2.", "hubert.", "model.")


def _resolve(checkpoint: str, config: str):
    ckpt = Path(checkpoint)
    if ckpt.is_dir():
        cfg_path = ckpt / "config.json"
        for name in ("model.safetensors", "pytorch_model.bin"):
            if (ckpt / name).exists():
                ckpt = ckpt / name
                break
        else:
            raise FileNotFoundError(f"no weights file in {checkpoint}")
    else:
        cfg_path = Path(config) if config else ckpt.parent / "config.json"
    with open(cfg_path) as f:
        hf_cfg = types.SimpleNamespace(**json.load(f))
    return ckpt, hf_cfg


def strip_prefix(sd):
    """The state dict with the first task-head prefix found removed (keys
    without it dropped), as the JAX CLI does."""
    for prefix in PREFIXES:
        if any(k.startswith(prefix) for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items()
                    if k.startswith(prefix)}
    return sd


def main(argv=None) -> None:
    from espnet_tpu_torch.train import hf_import
    from espnet_tpu_torch.train.msgpack_io import save_tree
    from espnet_tpu_torch.utils.config import dataclass_to_dict

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_type", required=True,
                   choices=["wav2vec2", "hubert", "whisper"])
    p.add_argument("--checkpoint", required=True,
                   help="torch .bin/.pt/.safetensors file or HF model dir")
    p.add_argument("--config", default="",
                   help="HF config.json (defaults to alongside checkpoint)")
    p.add_argument("--out", required=True, help="output .msgpack path")
    args = p.parse_args(argv)

    ckpt, hf_cfg = _resolve(args.checkpoint, args.config)
    sd = strip_prefix(hf_import.load_torch_state_dict(str(ckpt)))
    if args.model_type in ("wav2vec2", "hubert"):
        cfg = hf_import.ssl_config_from_hf(hf_cfg)
        tree = {"params": hf_import.wav2vec2_params_from_torch(sd, cfg)}
    else:
        cfg = hf_import.whisper_config_from_hf(hf_cfg)
        tree = {
            "encoder": hf_import.whisper_encoder_params_from_torch(sd, cfg),
            "decoder": hf_import.whisper_decoder_params_from_torch(sd, cfg),
        }
    save_tree(args.out, tree)
    meta = dataclass_to_dict(cfg)
    meta.pop("dtype", None)
    with open(str(args.out) + ".json", "w") as f:
        json.dump({"model_type": args.model_type, "config": meta}, f,
                  indent=2)
    print(f"wrote {args.out} ({args.model_type}); "
          f"config sidecar: {args.out}.json")


if __name__ == "__main__":
    main()
