"""Recipe runner, the `run.sh` equivalent (port of espnet_tpu/bin/run.py).

Drives the staged pipeline of `espnet_tpu_torch/recipe.py` (reference
`egs2/TEMPLATE/asr1/asr.sh` called from `egs2/<corpus>/asr1/run.sh`):

    python -m espnet_tpu_torch.bin.run --config conf/recipe.yaml \
        --recipe.stage 1 --recipe.stop_stage 12 [--device cpu]

All RecipeConfig fields are exposed as `--recipe.<field>` flags; YAML
config files use a top-level `recipe:` section (read with the port's YAML
codec). Stages already completed (`.stage<N>.done` markers in the exp dir)
are skipped; `--force true` re-runs them. The model stages run on the CUDA
card, and the runner raises before stage 1 without one, unless `--device
cpu` is given; the device goes to every CLI that runs the model.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.recipe import Recipe, RecipeConfig
from espnet_tpu_torch.utils.config import dataclass_from_dict, load_yaml


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--force", default="false")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    for f in dataclasses.fields(RecipeConfig):
        p.add_argument(f"--recipe.{f.name}", dest=f"recipe_{f.name}",
                       default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.config:
        raw = load_yaml(args.config)
        cfg = dataclass_from_dict(RecipeConfig, raw.get("recipe", raw))
    else:
        cfg = RecipeConfig()
    overrides = {}
    for f in dataclasses.fields(RecipeConfig):
        v = getattr(args, f"recipe_{f.name}")
        if v is not None:
            overrides[f.name] = type(getattr(cfg, f.name))(v) \
                if not isinstance(getattr(cfg, f.name), bool) \
                else v.lower() in ("1", "true", "yes")
    cfg = dataclasses.replace(cfg, **overrides)
    Recipe(cfg, device=str(device)).run(
        force=args.force.lower() in ("1", "true", "yes"))


if __name__ == "__main__":
    main()
