"""Train a speaker embedder on a corpus and dump per-utterance embeddings
(port of espnet_tpu/bin/spk_embed_extract.py).

The x-vector stage of the reference TTS recipe (`egs2/TEMPLATE/tts1/
tts.sh:346`). No pretrained extractor is available offline, so the TDNN +
statistics-pooling embedder (`models/tts/spk_embed.py`) is trained here on
the corpus's utt2spk labels (speaker cross-entropy, Adam), then each dump
dir gets `spk_embed.scp` and `spk2emb.scp` (per-speaker means) over npy
files. Writes `extractor.msgpack` (the JAX variables {"params": ...}, flax's
msgpack), `feat_stats.npz` and `spk2id`, as the JAX CLI does. Features: the
log-mel at the frontend's defaults (512 / 128), cut at `--max_frames`,
normalised with the training frames' mean and std. Runs on the CUDA card
unless `--device cpu` is given. Usage:

    python -m espnet_tpu_torch.bin.spk_embed_extract \
        --train_dir data/train --dump_dirs data/train data/dev data/test \
        --output_dir exp/spk_embed --epochs 20 [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", required=True)
    p.add_argument("--dump_dirs", nargs="+", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--channels", type=int, default=128)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--n_mels", type=int, default=80)
    p.add_argument("--max_frames", type=int, default=800)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def load_feats(datadir: Path, n_mels: int, max_frames: int):
    """{uid: (T, n_mels) log-mel} of a data dir's wav.scp."""
    import torch

    from espnet_tpu_torch.data.fileio import read_2column_text, read_wav
    from espnet_tpu_torch.ops.stft import log_mel_spectrogram

    out = {}
    for utt, path in read_2column_text(datadir / "wav.scp").items():
        x, _ = read_wav(path)
        f, fl = log_mel_spectrogram(
            torch.from_numpy(np.asarray(x, np.float32)[None]),
            torch.tensor([len(x)]), n_mels=n_mels)
        out[utt] = f[0, :min(int(fl[0]), max_frames)].numpy()
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    import torch
    import torch.nn.functional as F

    from espnet_tpu_torch.convert import state_dict_to_jax_params
    from espnet_tpu_torch.data.fileio import read_2column_text
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.models.asr import init_random_
    from espnet_tpu_torch.models.tts.spk_embed import \
        SpeakerEmbeddingExtractor
    from espnet_tpu_torch.train.msgpack_io import save_tree

    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    train_dir = Path(args.train_dir)
    utt2spk = read_2column_text(train_dir / "utt2spk")
    spks = sorted(set(utt2spk.values()))
    spk2id = {s: i for i, s in enumerate(spks)}
    (out / "spk2id").write_text(
        "".join(f"{s} {i}\n" for s, i in spk2id.items()))

    feats = load_feats(train_dir, args.n_mels, args.max_frames)
    utts = sorted(feats)
    t_max = max(f.shape[0] for f in feats.values())
    x = np.zeros((len(utts), t_max, args.n_mels), np.float32)
    lens = np.zeros((len(utts),), np.int64)
    labels = np.zeros((len(utts),), np.int64)
    for i, u in enumerate(utts):
        f = feats[u]
        x[i, :f.shape[0]] = f
        lens[i] = f.shape[0]
        labels[i] = spk2id[utt2spk[u]]
    frames = x[x.sum(-1) != 0]
    mean, std = frames.mean(0), np.maximum(frames.std(0), 1e-5)
    x = (x - mean) / std

    model = SpeakerEmbeddingExtractor(args.n_mels, n_spk=len(spks),
                                      embed_dim=args.embed_dim,
                                      channels=args.channels)
    init_random_(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    xt, lt, yt = (torch.from_numpy(a).to(device) for a in (x, lens, labels))
    rng = np.random.RandomState(args.seed)
    n = len(utts)
    bs = min(args.batch_size, n)
    for ep in range(args.epochs):
        order = rng.permutation(n)
        tot, cnt = 0.0, 0
        for i in range(0, n - bs + 1, bs):
            idx = torch.from_numpy(order[i:i + bs]).to(device)
            _, logits = model(xt[idx], lt[idx], logits=True)
            loss = F.cross_entropy(logits.float(), yt[idx])
            opt.zero_grad()
            loss.backward()
            opt.step()
            tot += float(loss.detach())
            cnt += 1
        if (ep + 1) % max(1, args.epochs // 5) == 0:
            logger.info("epoch %d: ce %.4f", ep + 1, tot / max(cnt, 1))

    save_tree(out / "extractor.msgpack",
              {"params": state_dict_to_jax_params(model.state_dict())})
    np.savez(out / "feat_stats.npz", mean=mean, std=std)

    model.eval()
    for d in map(Path, args.dump_dirs):
        dfeats = load_feats(d, args.n_mels, args.max_frames)
        emb_dir = out / "embs" / d.name
        emb_dir.mkdir(parents=True, exist_ok=True)
        scp_lines, spk_acc = [], {}
        du2s = read_2column_text(d / "utt2spk") \
            if (d / "utt2spk").exists() else {}
        with torch.no_grad():
            for utt in sorted(dfeats):
                f = (dfeats[utt] - mean) / std
                e = model(torch.from_numpy(f[None].astype(np.float32)).to(
                    device), torch.tensor([f.shape[0]], device=device))
                e = e[0].float().cpu().numpy()
                npy = emb_dir / f"{utt}.npy"
                np.save(npy, e)
                scp_lines.append(f"{utt} {npy.resolve()}\n")
                if utt in du2s:
                    spk_acc.setdefault(du2s[utt], []).append(e)
        (d / "spk_embed.scp").write_text("".join(scp_lines))
        mean_lines = []
        for s, es in sorted(spk_acc.items()):
            npy = emb_dir / f"spk_{s}.npy"
            np.save(npy, np.mean(es, axis=0))
            mean_lines.append(f"{s} {npy.resolve()}\n")
        (d / "spk2emb.scp").write_text("".join(mean_lines))
        logger.info("dumped %d embeddings -> %s", len(scp_lines),
                    d / "spk_embed.scp")


if __name__ == "__main__":
    main()
