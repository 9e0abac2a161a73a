"""Port of espnet_tpu/models/enh: the enhancement and separation family
and the ASR frontend's beamformer."""

from espnet_tpu_torch.models.enh.model import EnhancementModel, EnhConfig

__all__ = ["EnhancementModel", "EnhConfig"]
