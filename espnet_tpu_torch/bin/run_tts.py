"""TTS recipe runner, the `tts1/run.sh` equivalent (port of
espnet_tpu/bin/run_tts.py). Drives `espnet_tpu_torch/recipe_tts.py`:

    python -m espnet_tpu_torch.bin.run_tts --recipe.stage 1 \
        --recipe.stop_stage 9 [--device cpu]

Every RecipeTTSConfig field is a `--recipe.<field>` flag; a YAML config
file has a top-level `recipe:` section. The stages run the port's CLIs as
subprocesses, on the CUDA card unless `--device cpu` is given (the runner
raises without a card otherwise).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from espnet_tpu_torch.device import resolve_device
from espnet_tpu_torch.recipe_tts import RecipeTTS, RecipeTTSConfig
from espnet_tpu_torch.utils.config import dataclass_from_dict, load_yaml


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None)
    p.add_argument("--force", default="false")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card; raises without one) or cpu")
    for f in dataclasses.fields(RecipeTTSConfig):
        p.add_argument(f"--recipe.{f.name}", dest=f"recipe_{f.name}",
                       default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.config:
        raw = load_yaml(args.config)
        cfg = dataclass_from_dict(RecipeTTSConfig, raw.get("recipe", raw))
    else:
        cfg = RecipeTTSConfig()
    overrides = {}
    for f in dataclasses.fields(RecipeTTSConfig):
        v = getattr(args, f"recipe_{f.name}")
        if v is not None:
            overrides[f.name] = type(getattr(cfg, f.name))(v) \
                if not isinstance(getattr(cfg, f.name), bool) \
                else v.lower() in ("1", "true", "yes")
    cfg = dataclasses.replace(cfg, **overrides)
    RecipeTTS(cfg, device=str(device)).run(
        force=args.force.lower() in ("1", "true", "yes"))


if __name__ == "__main__":
    main()
