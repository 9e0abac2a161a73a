"""Partial parameter transfer from pretrained checkpoints (port of
espnet_tpu/train/pretrained.py).

`--run.init_param path:src:dst:excludes` copies the subtree under `src` of a
params msgpack (written by either package: the JAX param tree) into the
subtree under `dst` of the model's param tree, skipping excluded keys and
shape mismatches. Paths are the JAX tree's ("encoder/layer0/ff1/w1/kernel");
the caller converts the port's state_dict to that tree and back
(`convert.state_dict_to_jax_params`, `convert.jax_params_to_state_dict`).
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

import numpy as np

from espnet_tpu_torch.train.msgpack_io import flatten, load_tree, unflatten

logger = logging.getLogger("espnet_tpu")


def parse_init_param(spec: str) -> Tuple[str, str, str, Tuple[str, ...]]:
    """"path:src:dst:excl1,excl2" -> (path, src, dst, excludes)."""
    parts = (spec.split(":") + ["", "", ""])[:4]
    path, src, dst, excl = parts
    excludes = tuple(x for x in excl.split(",") if x)
    return path, src, dst, excludes


def load_pretrained(params: Dict, spec: str) -> Tuple[Dict, int, int]:
    """`params`: a JAX-layout param tree (nested dicts of numpy arrays).
    Returns (updated params, n_copied, n_considered)."""
    path, src_key, dst_key, excludes = parse_init_param(spec)
    flat_src = flatten(load_tree(path), sep="/")
    flat_dst = dict(flatten(params, sep="/"))
    copied = considered = 0
    for k, v in flat_src.items():
        if src_key:
            if not (k == src_key or k.startswith(src_key + "/")):
                continue
            rel = k[len(src_key):].lstrip("/")
        else:
            rel = k
        dk = f"{dst_key}/{rel}".strip("/") if dst_key else rel
        if any(e in dk for e in excludes):
            continue
        considered += 1
        cur = flat_dst.get(dk)
        if cur is not None and np.shape(cur) == np.shape(v):
            flat_dst[dk] = np.asarray(v, dtype=np.asarray(cur).dtype)
            copied += 1
        else:
            logger.warning("init_param: no match for %s", dk)
    logger.info("init_param %s: copied %d/%d arrays", path, copied,
                considered)
    return unflatten(flat_dst, sep="/"), copied, considered
