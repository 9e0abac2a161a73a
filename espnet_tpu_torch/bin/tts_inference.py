"""TTS inference CLI: text -> mel -> Griffin-Lim -> wav (port of
espnet_tpu/bin/tts_inference.py; reference `espnet2/bin/tts_inference.py:34`,
its Griffin-Lim path). Usage:

    python -m espnet_tpu_torch.bin.tts_inference --exp_dir exp/tts \
        --data_dir data/test --output_dir exp/tts/synth [--device cpu]

Writes `wav/<uid>.wav` and `wav/<uid>.mel.npy` (the denormalised mel of the
utterance's length), as the JAX CLI does. Texts go in chunks of
`--batch_size` in the data dir's order. Randomness: Tacotron2's prenet
dropout (always on) from a generator seeded 2, ProDiff's noise from one
seeded 3, Griffin-Lim's phase from one seeded 0. Griffin-Lim inverts the
mel filterbank of the frontend's default band (fmin 0, no fmax) at the
model's n_fft, as the JAX CLI does. `--vocoder_dir` (a GAN vocoder) is
not ported yet: ROADMAP.md queue 1 item 9, its second part.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")

VOCODER_TODO = ("--vocoder_dir needs the GAN vocoder task, which the port "
                "does not have yet (ROADMAP.md queue 1 item 9, its second "
                "part: HiFiGAN and the vocoders)")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True, help="dir with a 'text' file")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--max_frames", type=int, default=1024)
    p.add_argument("--griffin_lim_iters", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--vocoder_dir", default=None,
                   help="a GAN vocoder experiment; not ported yet")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def load_tts_experiment(exp: Path, params=None, device="cpu"):
    """(model on `device` in eval mode with its parameters and global-MVN
    statistics, the config sections, tokenizer, token converter, (mean,
    inv_std) or None) of a TTS experiment written by either package. The
    BatchNorm running statistics are the initial ones: the params files
    hold none, and the JAX CLI does the same (ROADMAP.md queue 3)."""
    from espnet_tpu_torch.bin.asr_inference import load_variables
    from espnet_tpu_torch.ops.normalize import global_mvn_params
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.tasks.tts import TTSTask, tokenizer_section
    from espnet_tpu_torch.train.collect_stats import load_stats

    cfg = TTSTask.load_config(exp)
    tok = tokenizer_section(cfg["data"])
    tokenizer = ASRTask.build_tokenizer(tok, exp)
    converter = ASRTask.build_token_list(tok, exp, tokenizer)
    mc = cfg["model"]
    model = TTSTask.build_model(mc, len(converter))
    load_variables(model, exp, params)
    stats_path = exp / "stats" / "feats_stats.npz"
    mvn = None
    if mc.normalize == "global_mvn" and stats_path.exists():
        mvn = global_mvn_params(load_stats(stats_path))
    return model.to(device).eval(), cfg, tokenizer, converter, mvn


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    if args.vocoder_dir:
        raise NotImplementedError(VOCODER_TODO)
    import torch

    from espnet_tpu_torch.data.fileio import read_2column_text, write_wav
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.ops.griffin_lim import logmel_to_wav
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("tts_inference")
    device = resolve_device(args.device)
    exp, out = Path(args.exp_dir), Path(args.output_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    model, cfg, tokenizer, converter, mvn = load_tts_experiment(
        exp, args.params, device)
    mc = cfg["model"]
    texts = read_2column_text(Path(args.data_dir) / "text")
    dropout_gen = torch.Generator().manual_seed(2)
    noise_gen = torch.Generator().manual_seed(3)
    keys = list(texts)
    for i in range(0, len(keys), args.batch_size):
        chunk = keys[i:i + args.batch_size]
        ids = [converter.tokens2ids(tokenizer.text2tokens(texts[k]))
               for k in chunk]
        u = max(len(x) for x in ids)
        text = np.zeros((len(chunk), u), np.int64)
        lens = np.zeros((len(chunk),), np.int64)
        for j, x in enumerate(ids):
            text[j, :len(x)] = x
            lens[j] = len(x)
        gen = noise_gen if mc.tts_type == "prodiff" else dropout_gen
        mel, mel_lens = model.inference(
            torch.from_numpy(text).to(device),
            torch.from_numpy(lens).to(device), args.max_frames,
            generator=gen)
        if mvn is not None:
            mean, inv_std = (torch.from_numpy(a).to(device) for a in mvn)
            mel = mel.float() / inv_std.clamp(min=1e-8) + mean
        wav = logmel_to_wav(mel.float(), mc.fs, mc.n_fft, mc.hop_length,
                            mc.win_length, mc.n_mels, args.griffin_lim_iters)
        wav, mel, mel_lens = (x.cpu().numpy() for x in (wav, mel.float(),
                                                         mel_lens))
        for j, k in enumerate(chunk):
            n = int(mel_lens[j]) * mc.hop_length
            write_wav(out / "wav" / f"{k}.wav", wav[j, :n], mc.fs)
            np.save(out / "wav" / f"{k}.mel.npy", mel[j, :int(mel_lens[j])])
        logger.info("synthesized %d/%d", min(i + len(chunk), len(keys)),
                    len(keys))


if __name__ == "__main__":
    main()
