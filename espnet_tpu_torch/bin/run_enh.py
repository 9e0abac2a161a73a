"""Enhancement recipe runner, the `enh1/run.sh` equivalent (port of
espnet_tpu/bin/run_enh.py). Drives `espnet_tpu_torch/recipe_enh.py`:

    python -m espnet_tpu_torch.bin.run_enh --recipe.stage 1 \
        --recipe.stop_stage 7 [--device cpu]

Every RecipeEnhConfig field is a `--recipe.<field>` flag; a YAML config
file has a top-level `recipe:` section. The stages run the port's CLIs as
subprocesses, on the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from espnet_tpu_torch.device import resolve_device

from espnet_tpu_torch.recipe_enh import RecipeEnh, RecipeEnhConfig
from espnet_tpu_torch.utils.config import dataclass_from_dict, load_yaml


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--force", default="false")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    for f in dataclasses.fields(RecipeEnhConfig):
        p.add_argument(f"--recipe.{f.name}", dest=f"recipe_{f.name}",
                       default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.config:
        raw = load_yaml(args.config)
        cfg = dataclass_from_dict(RecipeEnhConfig, raw.get("recipe", raw))
    else:
        cfg = RecipeEnhConfig()
    overrides = {}
    for f in dataclasses.fields(RecipeEnhConfig):
        v = getattr(args, f"recipe_{f.name}")
        if v is not None:
            overrides[f.name] = type(getattr(cfg, f.name))(v) \
                if not isinstance(getattr(cfg, f.name), bool) \
                else v.lower() in ("1", "true", "yes")
    cfg = dataclasses.replace(cfg, **overrides)
    RecipeEnh(cfg, device=str(device)).run(force=args.force.lower() in ("1", "true", "yes"))


if __name__ == "__main__":
    main()
