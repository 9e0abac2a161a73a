"""JETS inference CLI: a text dir -> wavs, end to end (port of
espnet_tpu/bin/jets_inference.py):

    python -m espnet_tpu_torch.bin.jets_inference --exp_dir E \
        --data_dir D --output_dir O [--device cpu]

Reads an experiment of either package's `jets_train`; writes
`wav/<uid>.wav`. JETS synthesis draws nothing.
"""

from __future__ import annotations

import argparse
import logging

from espnet_tpu_torch.bin.vits_inference import synthesise


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.tasks.jets import JETSTask

    return synthesise(args, JETSTask, "jets_inference",
                      lambda gen, t, tl: gen.inference(t, tl))


if __name__ == "__main__":
    main()
