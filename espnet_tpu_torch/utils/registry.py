# Copy of espnet_tpu/utils/registry.py (the port imports nothing of
# espnet_tpu); its imports point at the port's modules.
# Copy of espnet_tpu/utils/registry.py: the port imports nothing of espnet_tpu.
# Its imports point at the port's modules.
"""Component registries: third-party classes without source edits.

Behavioral spec: reference `espnet2/train/class_choices.py:1` (ClassChoices
— each task exposes `--<component> <name>` plus `--<component>_conf` dict,
resolved against a registered name->class table, so external packages can
add components by registering them). The TPU build keeps typed dataclass
configs for the built-ins and uses this registry as the extension point:
an unknown `encoder_type`/`decoder_type`/`separator_type`/... falls
through to the registry before erroring, and the plugin class receives the
standard constructor signature plus the section's `*_conf` dict.

Usage (plugin side):

    from espnet_tpu_torch.utils.registry import register

    @register("encoder", "my_encoder")
    class MyEncoder(nn.Module):
        d_model: int
        ...     # must accept (feats, lengths, deterministic) like the
                # built-in encoders and return (out, out_lengths)

Then `--model.encoder_type my_encoder --model.encoder_conf '{"k": 1}'`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

_REGISTRIES: Dict[str, Dict[str, Any]] = defaultdict(dict)


def register(kind: str, name: str) -> Callable[[Any], Any]:
    """Class decorator: register `cls` under (kind, name)."""

    def deco(cls):
        prev = _REGISTRIES[kind].get(name)
        if prev is not None and prev is not cls:
            raise ValueError(
                f"{kind!r} registry already has {name!r} -> {prev!r}"
            )
        _REGISTRIES[kind][name] = cls
        return cls

    return deco


def get(kind: str, name: str) -> Optional[Any]:
    """Look up a registered class; None if absent."""
    return _REGISTRIES[kind].get(name)


def available(kind: str) -> List[str]:
    return sorted(_REGISTRIES[kind])


def resolve(kind: str, name: str, builtin_error: str) -> Any:
    """Registry lookup that raises a helpful error listing both the
    builtin spelling problem and any registered plugins."""
    cls = get(kind, name)
    if cls is None:
        extra = available(kind)
        hint = f"; registered plugins: {extra}" if extra else ""
        raise ValueError(f"{builtin_error}{hint}")
    return cls
