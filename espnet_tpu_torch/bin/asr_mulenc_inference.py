"""Multi-encoder ASR inference CLI (port of
espnet_tpu/bin/asr_mulenc_inference.py): joint CTC/attention beam search
over the HAN-fused decoder, with the CTC streams fused log-linearly by
`weights_ctc_dec`. Usage:

    python -m espnet_tpu_torch.bin.asr_mulenc_inference \
        --exp_dir exp/mulenc --data_dir data/test --output_dir exp/decode \
        --beam_size 10 --ctc_weight 0.3 [--params path.msgpack] \
        [--device cpu]

The parser is the JAX CLI's, plus `--device` (default cuda: the card,
raising without one). The experiment directory may come from either
package. Batches are formed in the data dir's key order, as in JAX. Writes
`text`, `rtf.txt` and, with a reference `text`, `score_wer.txt`. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--max_steps", type=int, default=96)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


class Speech2TextMulEnc:
    """Batched beam search over the stacked multi-encoder memory, with the
    fused lengths min over the streams, as in JAX; runs on the card unless
    device="cpu"."""

    def __init__(self, model, converter, beam_size: int = 10,
                 ctc_weight: float = 0.3, max_steps: int = 96,
                 device="cuda"):
        from espnet_tpu_torch.decode.beam_search import BeamSearchConfig
        from espnet_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.converter = converter
        self.search_cfg = BeamSearchConfig(
            beam_size=beam_size, att_weight=1.0 - ctc_weight,
            ctc_weight=ctc_weight)
        self.max_steps = max_steps

    @torch.no_grad()
    def decode_batch(self, speech, stream_lengths):
        """(B, N, E) waveforms, (B, E) lengths on the device -> (yseq (B, W,
        L), ylen (B, W), score (B, W))."""
        from espnet_tpu_torch.decode.beam_search import batched_beam_search

        model, cfg = self.model, self.model.config
        w = self.search_cfg.beam_size
        enc, elens = model.encode(speech, stream_lengths)  # (B, E, T, D)
        b = enc.shape[0]
        ctc_lp = (model.ctc_log_probs(enc)
                  if self.search_cfg.ctc_weight > 0 else None)
        fused_lens = elens.min(dim=1).values
        mem = enc.repeat_interleave(w, dim=0)
        mem_lens = elens.repeat_interleave(w, dim=0)
        att_cache = model.decoder_init_cache(b * w, self.max_steps + 1, mem)

        def att_score_fn(tokens, pos, cache):
            return model.decoder_score_step(tokens, pos, mem, mem_lens,
                                            cache)

        return batched_beam_search(
            self.search_cfg, cfg.sos_id, cfg.eos_id, cfg.vocab_size,
            fused_lens, att_score_fn, att_cache, ctc_log_probs=ctc_lp,
            max_steps=self.max_steps)

    def __call__(self, speech, stream_lengths, keys):
        """[(key, text, score)] of the best hypotheses."""
        yseq, ylen, score = (t.cpu().numpy() for t in self.decode_batch(
            torch.as_tensor(np.asarray(speech, np.float32)).to(self.device),
            torch.as_tensor(np.asarray(stream_lengths, np.int64)).to(
                self.device)))
        out = []
        for i, key in enumerate(keys):
            ids = yseq[i, 0, : ylen[i, 0]].tolist()
            toks = self.converter.ids2tokens(ids)
            text = "".join(toks).replace("▁", " ").strip()
            out.append((key, text, float(score[i, 0])))
        return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("asr_mulenc_inference")
    from espnet_tpu_torch.bin.asr_inference import pick_params_file
    from espnet_tpu_torch.convert import load_jax_params
    from espnet_tpu_torch.data.dataset import ASRMulEncDataset
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.data.tokenizer import (TokenIDConverter,
                                                 build_tokenizer)
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.tasks.asr_mulenc import ASRMulEncTask
    from espnet_tpu_torch.train.msgpack_io import load_tree
    from espnet_tpu_torch.utils.metrics import sclite_report

    device = resolve_device(args.device)
    exp = Path(args.exp_dir)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = ASRMulEncTask.load_config(exp)
    data = cfg["data"]
    mc = cfg["model"]
    tokenizer = build_tokenizer(data.token_type, data.bpe_model or None)
    conv = TokenIDConverter.from_file(exp / "tokens.txt")
    model = ASRMulEncTask.build_model(mc, len(conv))
    n_enc = mc.num_encoders
    ds = ASRMulEncDataset(args.data_dir, tokenizer, conv, n_enc, data.fs)
    params_file = Path(args.params) if args.params else pick_params_file(exp)
    logger.info("loading params: %s", params_file)
    load_jax_params(model, {"params": load_tree(params_file)})
    s2t = Speech2TextMulEnc(model, conv, args.beam_size, args.ctc_weight,
                            args.max_steps, device=device)

    keys = list(ds.keys())
    hyps_text = {}
    audio_seconds = decode_seconds = 0.0
    for i in range(0, len(keys), args.batch_size):
        chunk = keys[i:i + args.batch_size]
        items = [ds[k] for k in chunk]
        n = max(it["speech"].shape[0] for it in items)
        buf = np.zeros((len(items), n, n_enc), np.float32)
        slens = np.zeros((len(items), n_enc), np.int32)
        for j, it in enumerate(items):
            buf[j, : it["speech"].shape[0]] = it["speech"]
            slens[j] = it["speech_stream_lengths"]
        audio_seconds += float(slens.max(axis=1).sum()) / data.fs
        t0 = time.perf_counter()
        for key, text, _ in s2t(buf, slens, chunk):
            hyps_text[key] = text
        decode_seconds += time.perf_counter() - t0
        logger.info("decoded %d utts", len(hyps_text))
    write_2column_text(out / "text", hyps_text)
    if audio_seconds > 0:
        rtf = decode_seconds / audio_seconds
        (out / "rtf.txt").write_text(
            f"decode_s {decode_seconds:.3f} audio_s {audio_seconds:.3f} "
            f"RTF {rtf:.4f}\n")
        logger.info("RTF %.4f (%.1fs decode / %.1fs audio)", rtf,
                    decode_seconds, audio_seconds)

    ref_path = Path(args.data_dir) / "text"
    if ref_path.exists():
        refs = {k: v.split() for k, v in read_2column_text(ref_path).items()
                if k in hyps_text}
        hyp_words = {k: v.split() for k, v in hyps_text.items()}
        report = sclite_report(refs, hyp_words)
        (out / "score_wer.txt").write_text(report + "\n")
        logger.info("WER %s", report)
    return hyps_text


if __name__ == "__main__":
    main()
