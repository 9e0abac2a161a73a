"""Multi-speaker ASR inference CLI (port of
espnet_tpu/bin/asr_mix_inference.py): greedy CTC on every speaker branch,
scored with the best permutation's word errors when the data dir has every
`text_spk<i>`. Usage:

    python -m espnet_tpu_torch.bin.asr_mix_inference \
        --exp_dir exp/mix --data_dir data/test --output_dir exp/decode \
        [--params path.msgpack] [--device cpu]

The parser is the JAX CLI's, plus `--device` (default cuda: the card,
raising without one). The experiment directory may come from either
package. Writes `text` (one line `<key>_spk<s>` a branch) and, with the
references, `score_wer.txt` ("WER x.xx"), as JAX does, and `rtf.txt`. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
"""

from __future__ import annotations

import argparse
import itertools
import logging
import time
from pathlib import Path

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def greedy_paths(model, speech, lengths):
    """(B, N) mixtures on the model's device -> (frame-wise argmax (B, S,
    T') of every branch's CTC log-probs, encoder lengths (B,)), numpy."""
    import torch

    with torch.no_grad():
        enc, elens = model.encode(speech, lengths)
        b, s, t, _ = enc.shape
        lp = model.ctc_log_probs(enc.reshape(b * s, t, -1))
        paths = lp.argmax(-1).reshape(b, s, t)
    return paths.cpu().numpy(), elens.cpu().numpy()


def best_permutation_errors(refs, hyps):
    """The least total word errors over the assignments of hypotheses to
    references (lists of word lists)."""
    from espnet_tpu_torch.utils.metrics import edit_distance

    n = len(refs)
    return min(sum(edit_distance(refs[s], hyps[perm[s]]).errors
                   for s in range(n))
               for perm in itertools.permutations(range(n)))


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("asr_mix_inference")
    import numpy as np
    import torch

    from espnet_tpu_torch.bin.asr_inference import pick_params_file
    from espnet_tpu_torch.convert import load_jax_params
    from espnet_tpu_torch.data.dataset import ASRMixDataset
    from espnet_tpu_torch.data.fileio import read_2column_text
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_tokenizer)
    from espnet_tpu_torch.decode.ctc_greedy import collapse_ctc
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.tasks.asr_mix import ASRMixTask
    from espnet_tpu_torch.train.msgpack_io import load_tree

    device = resolve_device(args.device)
    exp = Path(args.exp_dir)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = ASRMixTask.load_config(exp)
    data = cfg["data"]
    mc = cfg["model"]
    tokenizer = build_tokenizer(data.token_type, data.bpe_model or None)
    conv = TokenIDConverter.from_file(exp / "tokens.txt")
    model = ASRMixTask.build_model(mc, len(conv))
    n_spk = mc.num_spk
    ds = ASRMixDataset(args.data_dir, tokenizer, conv, n_spk, data.fs)
    params_file = Path(args.params) if args.params else pick_params_file(exp)
    logger.info("loading params: %s", params_file)
    load_jax_params(model, {"params": load_tree(params_file)})
    model = model.to(device).eval()

    ref_paths = [Path(args.data_dir) / f"text_spk{i + 1}"
                 for i in range(n_spk)]
    refs = [read_2column_text(p) if p.exists() else None for p in ref_paths]
    has_refs = all(r is not None for r in refs)
    keys = list(ds.keys())
    total_err = total_ref = 0
    audio_seconds = decode_seconds = 0.0
    with open(out / "text", "w") as f:
        for i in range(0, len(keys), args.batch_size):
            chunk = keys[i:i + args.batch_size]
            wavs = [ds[k]["speech"] for k in chunk]
            n = max(len(w) for w in wavs)
            buf = np.zeros((len(wavs), n), np.float32)
            lens = np.zeros((len(wavs),), np.int32)
            for j, w in enumerate(wavs):
                buf[j, : len(w)] = w
                lens[j] = len(w)
            audio_seconds += float(lens.sum()) / data.fs
            t0 = time.perf_counter()
            paths, elens = greedy_paths(
                model, torch.from_numpy(buf).to(device),
                torch.from_numpy(lens).to(device))
            decode_seconds += time.perf_counter() - t0
            for j, k in enumerate(chunk):
                hyps = []
                for s in range(n_spk):
                    ids = collapse_ctc(paths[j, s, : int(elens[j])])
                    toks = conv.ids2tokens(ids)
                    hyps.append("".join(toks).replace("▁", " ").strip())
                for s, h in enumerate(hyps):
                    f.write(f"{k}_spk{s + 1} {h}\n")
                if has_refs:
                    rw = [refs[s][k].split() for s in range(n_spk)]
                    total_err += best_permutation_errors(
                        rw, [h.split() for h in hyps])
                    total_ref += sum(len(r) for r in rw)
    if audio_seconds > 0:
        rtf = decode_seconds / audio_seconds
        (out / "rtf.txt").write_text(
            f"decode_s {decode_seconds:.3f} audio_s {audio_seconds:.3f} "
            f"RTF {rtf:.4f}\n")
    if has_refs and total_ref:
        wer = 100.0 * total_err / total_ref
        logger.info("best-permutation WER: %.2f%%", wer)
        (out / "score_wer.txt").write_text(f"WER {wer:.2f}\n")
    logger.info("decoded %d utts -> %s", len(keys), out / "text")
    return out


if __name__ == "__main__":
    main()
