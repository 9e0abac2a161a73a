"""Corpus perplexity of a trained LM (port of
espnet_tpu/bin/lm_calc_perplexity.py). Usage:

    python -m espnet_tpu_torch.bin.lm_calc_perplexity --exp_dir exp/lm \
        --data_dir data/test --output_dir exp/lm/ppl_test [--device cpu]

The parser is the JAX CLI's, plus `--device` (default cuda: the card,
raising without one). The experiment directory may come from either
package. Writes `ppl` (exp of the summed token NLL over the token count,
eos included) and returns the perplexity. With ESPNET_TPU_TORCH_LAUNCH_LOG
set, the kernels' launch counts are appended to that file at exit
(`ops/launches.py`).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

logger = logging.getLogger("espnet_tpu")


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--params", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def load_lm_experiment(exp: Path, params=None, dtype=None):
    """(LMTrainModel with its parameters, tokenizer, token converter, the
    model section) of an LM experiment directory written by either
    package."""
    import dataclasses

    import torch

    from espnet_tpu_torch.bin.asr_inference import pick_params_file
    from espnet_tpu_torch.convert import load_jax_params
    from espnet_tpu_torch.data.tokenizer import TokenIDConverter
    from espnet_tpu_torch.tasks.lm import LMTask, lm_tokenizer
    from espnet_tpu_torch.train.msgpack_io import load_tree

    cfg = LMTask.load_config(exp)
    data = cfg["data"]
    if data.token_type == "bpe" and not data.bpe_model:
        data = dataclasses.replace(data, bpe_model=str(exp / "bpe.json"))
    tokenizer = lm_tokenizer(data)
    converter = TokenIDConverter.from_file(
        Path(data.token_list) if data.token_list else exp / "tokens.txt")
    model = LMTask.build_model(cfg["model"], len(converter),
                               dtype or torch.float32)
    params_file = Path(params) if params else pick_params_file(exp)
    logger.info("loading LM params: %s", params_file)
    load_jax_params(model, load_tree(params_file))
    return model, tokenizer, converter, cfg["model"]


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.ops.launches import log_at_exit

    log_at_exit("lm_calc_perplexity")
    import numpy as np
    import torch

    from espnet_tpu_torch.data.fileio import read_2column_text
    from espnet_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    model, tokenizer, converter, _ = load_lm_experiment(Path(args.exp_dir),
                                                        args.params)
    model = model.to(device).eval()
    texts = read_2column_text(Path(args.data_dir) / "text")
    keys = list(texts)
    total_nll = 0.0
    total_tok = 0
    with torch.no_grad():
        for i in range(0, len(keys), args.batch_size):
            chunk = keys[i:i + args.batch_size]
            ids = [np.asarray(converter.tokens2ids(
                tokenizer.text2tokens(texts[k])), np.int32) for k in chunk]
            u = max(len(a) for a in ids)
            buf = np.zeros((len(ids), u), np.int32)
            lens = np.zeros((len(ids),), np.int32)
            for j, a in enumerate(ids):
                buf[j, : len(a)] = a
                lens[j] = len(a)
            _, stats = model(torch.from_numpy(buf).to(device),
                             torch.from_numpy(lens).to(device))
            total_nll += float(stats["nll_sum"])
            total_tok += int(stats["ntokens"])
    ppl = float(np.exp(total_nll / max(total_tok, 1)))
    (out / "ppl").write_text(f"{ppl:.4f}\n")
    logger.info("perplexity: %.4f over %d tokens", ppl, total_tok)
    return ppl


if __name__ == "__main__":
    main()
