"""Enhancement inference CLI: separate a data dir of mixtures (port of
espnet_tpu/bin/enh_inference.py; reference `espnet2/bin/enh_inference.py`
SeparateSpeech). Usage:

    python -m espnet_tpu_torch.bin.enh_inference --exp_dir exp/enh \
        --data_dir data/test --output_dir exp/enh/sep [--device cpu]

Writes `wav/<key>_spk<i>.wav` (each cut to its mixture's length) and
`spk<i>.scp`; where the data dir has `spk1.scp`, the mean PIT-aligned
SI-SNR over the utterances goes to `si_snr.txt`. Mixtures go in
length-bucketed batches of `--batch_size`, as in the JAX CLI. The
experiment may come from either package; its params file is
`asr_inference.pick_params_file`'s choice unless `--params` names one.
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
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def load_enh_experiment(exp: Path, params=None, device="cpu"):
    """(model on `device` in eval mode with its parameters, the config
    sections) of an enhancement experiment written by either package."""
    from espnet_tpu_torch.bin.asr_inference import pick_params_file
    from espnet_tpu_torch.convert import load_jax_params
    from espnet_tpu_torch.tasks.enh import EnhTask
    from espnet_tpu_torch.train.msgpack_io import load_tree

    cfg = EnhTask.load_config(exp)
    model = EnhTask.build_model(cfg["model"])
    params_file = Path(params) if params else pick_params_file(exp)
    logger.info("loading params: %s", params_file)
    load_jax_params(model, {"params": load_tree(params_file)})
    return model.to(device).eval(), cfg


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    import numpy as np
    import torch

    from espnet_tpu_torch.data.dataset import EnhDataset, EpochIterator
    from espnet_tpu_torch.data.fileio import DatadirWriter, write_wav
    from espnet_tpu_torch.device import resolve_device
    from espnet_tpu_torch.ops.enh_losses import pit_solve, si_snr_loss
    from espnet_tpu_torch.tasks.enh import make_batches

    dev = resolve_device(args.device)
    exp = Path(args.exp_dir)
    out = Path(args.output_dir)
    (out / "wav").mkdir(parents=True, exist_ok=True)
    model, cfg = load_enh_experiment(exp, args.params, dev)
    n_spk = model.config.num_spk
    fs = cfg["data"].fs

    has_refs = (Path(args.data_dir) / "spk1.scp").exists()
    ds = EnhDataset(args.data_dir, n_spk if has_refs else 0, fs)
    batches = make_batches(ds, cfg["data"], batch_size=args.batch_size)
    fields = ("speech_mix", "speech_ref") if has_refs else ("speech_mix",)
    it = EpochIterator(ds, batches, shuffle=False, prefetch=2, fields=fields)

    si_snrs, n_done = [], 0
    with DatadirWriter(out) as w, torch.no_grad():
        for batch in it.epoch(0):
            keys = batch.pop("keys")
            mix = torch.as_tensor(batch["speech_mix"]).to(dev)
            lens = torch.as_tensor(batch["speech_mix_lengths"]).to(dev)
            est, _ = model.forward_enhance(mix, lens)
            est = est.float()
            if has_refs:
                refs = torch.as_tensor(batch["speech_ref"]).to(dev)
                loss, _ = pit_solve(lambda r, e: si_snr_loss(r, e, lens),
                                    refs.transpose(1, 2), est)
                si_snrs.extend((-loss).cpu().numpy().tolist())
            est_np = est.cpu().numpy()
            for bi, key in enumerate(keys):
                n = int(batch["speech_mix_lengths"][bi])
                for s in range(n_spk):
                    path = out / "wav" / f"{key}_spk{s + 1}.wav"
                    write_wav(path, est_np[bi, s, :n], fs)
                    w[f"spk{s + 1}.scp"][key] = str(path)
            n_done += len(keys)
            logger.info("separated %d utts", n_done)
    if si_snrs:
        mean_si_snr = float(np.mean(si_snrs))
        (out / "si_snr.txt").write_text(f"{mean_si_snr:.4f}\n")
        logger.info("mean SI-SNR: %.2f dB", mean_si_snr)
    return out


if __name__ == "__main__":
    main()
