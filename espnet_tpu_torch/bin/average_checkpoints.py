"""Average parameter snapshots (port of
espnet_tpu/bin/average_checkpoints.py).

    python -m espnet_tpu_torch.bin.average_checkpoints \
        --inputs ep3.params.msgpack ep4.params.msgpack --output ave.msgpack

Float leaves are averaged in float64 and written as float32, as
`CheckpointManager.average_nbest` writes <tag>.ave.params.msgpack; other
leaves come from the first input. (The JAX CLI sums in float32, so the two
packages' files can differ in the last bit.)
"""

from __future__ import annotations

import argparse


def get_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--output", required=True)
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    from espnet_tpu_torch.train.checkpoint import average_trees
    from espnet_tpu_torch.train.msgpack_io import load_tree, save_tree

    save_tree(args.output, average_trees([load_tree(p)
                                          for p in args.inputs]))
    return args.output


if __name__ == "__main__":
    main()
