"""ASR inference CLI: decode a data dir with a trained experiment (port of
espnet_tpu/bin/asr_inference.py). Usage:

    python -m espnet_tpu_torch.bin.asr_inference \
        --exp_dir exp/asr --data_dir data/test --output_dir exp/asr/decode \
        --beam_size 10 --ctc_weight 0.3 [--params path.msgpack] [--device cpu]

The parser is the JAX CLI's, plus `--device` (default cuda: the card, raising
without one). The experiment directory may come from either package. Writes
`text`, `nbest.jsonl`, `rtf.txt` and, with a reference `text`,
`score_wer.txt` and `score_cer.txt`. Shallow fusion, as in JAX:

* `--lm_exp_dir` with `--lm_weight` > 0 fuses a neural LM trained by
  `bin.lm_train` (either package's experiment directory; built over this
  model's token list, float32); without `--lm_exp_dir` the weight does
  nothing;
* `--ngram_file` (an ARPA file, `bin.ngram_train`) with `--ngram_weight`
  > 0 fuses the n-gram's dense tables (`lm/ngram.py`); either flag alone
  does nothing;
* `--word_lm_exp_dir` (an `lm_type rnn` LM trained on words, its own
  `tokens.txt`) with `--lm_weight` > 0 fuses a word LM into a character
  search (`decode/extlm.py`): alone as `LookAheadWordLM` (`--oov_penalty`,
  default 1e-4), with `--lm_exp_dir` (an `lm_type rnn` character LM) as
  `MultiLevelLM` (`--subwordlm_weight`, `--oov_penalty` default 1.0), which
  then consumes the character LM, so it is not fused a second time. A
  non-rnn word or character LM raises a ValueError.

`--search timesync` decodes with the frame-synchronous CTC prefix search
(`decode/timesync.py`; `--beam_size`, and the n-gram when given a weight,
which the JAX CLI cannot: ROADMAP.md queue 3). A CTC-only model (no
decoder) raises a ValueError in the label-synchronous search, and so does
a `--ctc_weight` > 0 for an attention-only model (no CTC head), where the
JAX CLI fails. With
ESPNET_TPU_TORCH_LAUNCH_LOG set, the kernels' launch counts are appended to
that file at exit (`ops/launches.py`).
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger("espnet_tpu")

def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--params", default=None,
                   help="params msgpack (default: best/averaged in exp_dir)")
    p.add_argument("--beam_size", type=int, default=10)
    p.add_argument("--search", choices=["label_sync", "timesync"],
                   default="label_sync",
                   help="label_sync = joint CTC/attention batched beam "
                        "search; timesync = frame-synchronous CTC prefix "
                        "beam search")
    p.add_argument("--ctc_weight", type=float, default=0.3)
    p.add_argument("--lm_weight", type=float, default=0.0)
    p.add_argument("--lm_exp_dir", default=None)
    p.add_argument("--word_lm_exp_dir", default=None)
    p.add_argument("--subwordlm_weight", type=float, default=0.8)
    p.add_argument("--oov_penalty", type=float, default=None)
    p.add_argument("--ngram_file", default=None, help="ARPA LM for fusion")
    p.add_argument("--ngram_weight", type=float, default=0.0)
    p.add_argument("--penalty", type=float, default=0.0)
    p.add_argument("--maxlenratio", type=float, default=0.0)
    p.add_argument("--minlenratio", type=float, default=0.0)
    p.add_argument("--max_steps", type=int, default=0,
                   help="hard cap on decode steps (0 = encoder length)")
    p.add_argument("--nbest", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def pick_params_file(exp_dir: Path) -> Path:
    for pat in ("*.ave.params.msgpack", "valid.acc.best.params.msgpack",
                "train.loss.best.params.msgpack", "ep*.params.msgpack"):
        hits = sorted(exp_dir.glob(pat))
        if hits:
            return hits[-1]
    raise FileNotFoundError(f"no params file in {exp_dir}")


def load_experiment(exp: Path, data_dir, params=None):
    """(model with its parameters and global-MVN stats, the data section,
    the dataset of `data_dir`, tokenizer, token converter) of an experiment
    directory written by either package; `params` names the params file
    (default: `pick_params_file`)."""
    from espnet_tpu_torch.tasks.asr import ASRTask

    cfg = ASRTask.load_config(exp)
    data = cfg["data"]
    tokenizer = ASRTask.build_tokenizer(data, exp)
    converter = ASRTask.build_token_list(data, exp, tokenizer)
    model = ASRTask.build_model(cfg["model"], len(converter))
    ds = ASRTask.build_dataset(data, data_dir, tokenizer, converter,
                               train=False)
    load_variables(model, exp, params)
    return model, data, ds, tokenizer, converter


def load_variables(model, exp: Path, params=None):
    """Load into `model` the params file `params` (default:
    `pick_params_file(exp)`) and, for a model with global MVN, the
    experiment's
    `stats/feats_stats.npz`; without stats, the identity statistics of
    the JAX init, with which the JAX package decodes (and the ST task,
    which collects none, trains)."""
    from espnet_tpu_torch.convert import load_jax_params
    from espnet_tpu_torch.train.collect_stats import load_stats, mvn_variables
    from espnet_tpu_torch.train.msgpack_io import load_tree

    params_file = Path(params) if params else pick_params_file(exp)
    logger.info("loading params: %s", params_file)
    variables = {"params": load_tree(params_file)}
    if hasattr(model, "mvn"):
        stats_path = exp / "stats" / "feats_stats.npz"
        dim = model.mvn.mean.numel()
        variables["mvn"] = (
            mvn_variables(load_stats(stats_path)) if stats_path.exists()
            else {"mvn": {"mean": np.zeros(dim, np.float32),
                          "inv_std": np.ones(dim, np.float32)}})
    return load_jax_params(model, variables)


def load_lm(lm_exp: Path, vocab_size: int):
    """The bare LM of an LM experiment directory (either package's), built
    over `vocab_size` tokens (the ASR model's token list, as JAX builds
    it), its parameters loaded."""
    from espnet_tpu_torch.convert import load_jax_params
    from espnet_tpu_torch.tasks.lm import LMTask
    from espnet_tpu_torch.train.msgpack_io import load_tree

    cfg = LMTask.load_config(lm_exp)
    model = LMTask.build_model(cfg["model"], vocab_size)
    params_file = pick_params_file(lm_exp)
    logger.info("loading LM params: %s", params_file)
    load_jax_params(model, load_tree(params_file))
    return model.lm


def word_lm_scorer(args, converter, char_lm, char_lm_exp, device):
    """The word LM of `--word_lm_exp_dir` as a weighted scorer (weight
    `--lm_weight`): `MultiLevelLM` with the character LM `char_lm` (from
    `char_lm_exp`), else `LookAheadWordLM`; both LMs on `device`."""
    from espnet_tpu_torch.data.tokenizer import TokenIDConverter
    from espnet_tpu_torch.decode.extlm import (LookAheadWordLM,
                                               MultiLevelLM,
                                               make_lexical_tree)
    from espnet_tpu_torch.decode.scorers import Scorer
    from espnet_tpu_torch.tasks.lm import LMTask

    wexp = Path(args.word_lm_exp_dir)
    if LMTask.load_config(wexp)["model"].lm_type != "rnn":
        raise ValueError(
            "--word_lm_exp_dir must be an lm_type=rnn LM: the word LM is "
            "consulted at each hypothesis's word boundaries, so its cache "
            "must be position-free")
    word_conv = TokenIDConverter.from_file(wexp / "tokens.txt")
    word_dict = {t: i for i, t in enumerate(word_conv.token_list)}
    subword_dict = {t: i for i, t in enumerate(converter.token_list)}
    word_eos = word_dict["<sos/eos>"]
    word_unk = word_dict.get("<unk>", 1)
    tree = make_lexical_tree(word_dict, subword_dict, word_unk)
    wlm = load_lm(wexp, len(word_conv)).to(device).eval()

    def step_fns(lm):
        def cache_init(b, dev):
            return lm.init_cache(b, device=dev)

        def step(cache, tokens):
            return lm.score_step(tokens, 0, cache)

        return step, cache_init

    space = subword_dict.get("<space>", -1)
    eos_id = len(converter) - 1          # <sos/eos> is last
    common = dict(tree=tree, word_eos=word_eos, word_unk=word_unk,
                  space=space, eos=eos_id, subword_size=len(converter))
    if char_lm is not None:
        if LMTask.load_config(char_lm_exp)["model"].lm_type != "rnn":
            raise ValueError("MultiLevelLM needs an lm_type=rnn character "
                             "LM in --lm_exp_dir (position-free cache)")
        scorer = MultiLevelLM(
            *step_fns(wlm), *step_fns(char_lm.to(device).eval()),
            subwordlm_weight=args.subwordlm_weight,
            oov_penalty=(args.oov_penalty if args.oov_penalty is not None
                         else 1.0), **common)
        name = "multilevel_lm"
    else:
        scorer = LookAheadWordLM(
            *step_fns(wlm), oov_penalty=(args.oov_penalty
                                         if args.oov_penalty is not None
                                         else 1e-4), **common)
        name = "lookahead_word_lm"
    return Scorer(args.lm_weight,
                  lambda n, steps, dev: scorer.init_cache(n, dev),
                  scorer.make_score_fn(), name=name)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("asr_inference")
    from espnet_tpu_torch.data.dataset import EpochIterator
    from espnet_tpu_torch.data.fileio import (read_2column_text,
                                              write_2column_text)
    from espnet_tpu_torch.data.sampler import build_batches
    from espnet_tpu_torch.decode.asr_inference import Speech2Text
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.utils.metrics import sclite_report

    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    model, data, ds, tokenizer, converter = load_experiment(
        Path(args.exp_dir), args.data_dir, args.params)
    shapes = {"speech": ds.speech_lengths(), "text": ds.text_lengths()}
    batches = build_batches(
        shapes, batch_size=args.batch_size,
        length_quantum=data.length_quantum, text_quantum=data.text_quantum,
    )
    it = EpochIterator(ds, batches, shuffle=False, prefetch=2)
    lm_model = None
    if args.lm_exp_dir and args.lm_weight > 0:
        lm_model = load_lm(Path(args.lm_exp_dir), len(converter))
    extra_scorers = []
    if args.word_lm_exp_dir and args.lm_weight > 0:
        extra_scorers.append(word_lm_scorer(
            args, converter, lm_model,
            Path(args.lm_exp_dir) if args.lm_exp_dir else None, device))
        lm_model = None  # a character LM rides inside MultiLevelLM
    ngram_scorer = None
    if args.ngram_file and args.ngram_weight > 0:
        from espnet_tpu_torch.lm.ngram import DenseNgramScorer, NgramModel

        logger.info("loading ngram: %s", args.ngram_file)
        ngram_scorer = DenseNgramScorer(
            NgramModel.load_arpa(args.ngram_file), converter.token_list)

    if args.search == "timesync":
        from espnet_tpu_torch.decode.timesync import Speech2TextTimeSync

        s2t = Speech2TextTimeSync(
            model, tokenizer, converter, beam_size=args.beam_size,
            ngram_scorer=ngram_scorer, ngram_weight=args.ngram_weight,
            device=device)
    else:
        s2t = Speech2Text(
            model, device=device, beam_size=args.beam_size,
            ctc_weight=args.ctc_weight, penalty=args.penalty,
            maxlenratio=args.maxlenratio, minlenratio=args.minlenratio,
            max_steps=args.max_steps, tokenizer=tokenizer,
            converter=converter, lm_model=lm_model,
            lm_weight=args.lm_weight, ngram_scorer=ngram_scorer,
            ngram_weight=args.ngram_weight, extra_scorers=extra_scorers,
        )

    hyps_text = {}
    nbest_rows = []
    audio_seconds = 0.0
    decode_seconds = 0.0
    for batch in it.epoch(0):
        keys = batch.pop("keys")
        if data.input_type == "raw":
            audio_seconds += float(np.sum(batch["speech_lengths"])) / data.fs
        t0 = time.perf_counter()
        results = s2t(batch["speech"], batch["speech_lengths"], keys=keys,
                      nbest=args.nbest)
        decode_seconds += time.perf_counter() - t0
        for r in results:
            hyps_text[r.key] = r.text
            nbest_rows.append({
                "key": r.key, "text": r.text, "score": r.score,
                "nbest": [{"ids": ids, "score": s} for ids, s in r.nbest],
            })
        logger.info("decoded %d utts", len(hyps_text))
    write_2column_text(out / "text", hyps_text)
    if audio_seconds > 0:
        rtf = decode_seconds / audio_seconds
        (out / "rtf.txt").write_text(
            f"decode_s {decode_seconds:.3f} audio_s {audio_seconds:.3f} "
            f"RTF {rtf:.4f}\n"
        )
        logger.info("RTF %.4f (%.1fs decode / %.1fs audio)", rtf,
                    decode_seconds, audio_seconds)
    with open(out / "nbest.jsonl", "w") as f:
        for row in nbest_rows:
            f.write(json.dumps(row) + "\n")

    ref_path = Path(args.data_dir) / "text"
    if ref_path.exists():
        refs = {k: v.split() for k, v in read_2column_text(ref_path).items()
                if k in hyps_text}
        hyp_words = {k: v.split() for k, v in hyps_text.items()}
        report = sclite_report(refs, hyp_words)
        (out / "score_wer.txt").write_text(report + "\n")
        logger.info("WER %s", report)
        refs_c = {k: list(" ".join(v)) for k, v in refs.items()}
        hyps_c = {k: list(" ".join(v)) for k, v in hyp_words.items()}
        (out / "score_cer.txt").write_text(
            sclite_report(refs_c, hyps_c) + "\n"
        )
    return hyps_text


if __name__ == "__main__":
    main()
