"""VITS inference CLI: a text dir -> wavs, end to end (port of
espnet_tpu/bin/vits_inference.py; reference `espnet2/bin/tts_inference.py`
with a VITS model):

    python -m espnet_tpu_torch.bin.vits_inference --exp_dir E \
        --data_dir D --output_dir O [--noise_scale 0.667] [--device cpu]

Reads an experiment of either package's `vits_train` (config.yaml,
tokens.txt, generator.msgpack); writes `wav/<uid>.wav`. The prior's noise
comes from a generator seeded 7 (the JAX CLI's PRNGKey(7)): with
`--noise_scale 0` both packages synthesise the same waves.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_frames", type=int, default=1000)
    p.add_argument("--noise_scale", type=float, default=0.667)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def load_gan_tts(task, exp: Path, device):
    """(generator in eval mode on `device`, config, tokenizer, converter)
    of a VITS or JETS experiment written by either package."""
    from espnet_tpu_torch.convert import load_jax_params
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_tokenizer)
    from espnet_tpu_torch.train.msgpack_io import load_tree

    cfg = task.load_config(exp)
    data = cfg["data"]
    conv = TokenIDConverter.from_file(exp / "tokens.txt")
    gen, _ = task.build_models(cfg["model"], data, len(conv))
    load_jax_params(gen, load_tree(exp / "generator.msgpack"))
    return gen.to(device).eval(), cfg, build_tokenizer(data.token_type), conv


def synthesise(args, task, name, synth):
    """Read the texts in `--batch_size` chunks, call synth(tokens, lengths)
    -> (wav, wav lengths) and write the waves."""
    import torch

    from espnet_tpu_torch.data.fileio import read_2column_text, write_wav
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit(name)
    device = resolve_device(args.device)
    exp, out = Path(args.exp_dir), Path(args.output_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    gen, cfg, tokenizer, conv = load_gan_tts(task, exp, device)
    texts = read_2column_text(Path(args.data_dir) / "text")
    keys = list(texts)
    for i in range(0, len(keys), args.batch_size):
        chunk = keys[i:i + args.batch_size]
        ids = [conv.tokens2ids(tokenizer.text2tokens(texts[k]))
               for k in chunk]
        buf = np.zeros((len(ids), max(len(a) for a in ids)), np.int64)
        lens = np.array([len(a) for a in ids], np.int64)
        for j, a in enumerate(ids):
            buf[j, :len(a)] = a
        wav, wav_lens = synth(gen, torch.from_numpy(buf).to(device),
                              torch.from_numpy(lens).to(device))
        wav, wav_lens = wav.float().cpu().numpy(), wav_lens.cpu().numpy()
        for j, k in enumerate(chunk):
            write_wav(out / "wav" / f"{k}.wav", wav[j, :int(wav_lens[j])],
                      cfg["data"].fs)
        logger.info("synthesized %d/%d", i + len(chunk), len(keys))
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    import torch

    from espnet_tpu_torch.tasks.vits import VITSTask

    noise = {}

    def synth(gen, tokens, lengths):
        if "gen" not in noise:
            noise["gen"] = torch.Generator(
                device=tokens.device).manual_seed(7)
        return gen.inference(tokens, lengths, args.max_frames,
                             args.noise_scale, generator=noise["gen"])

    return synthesise(args, VITSTask, "vits_inference", synth)


if __name__ == "__main__":
    main()
