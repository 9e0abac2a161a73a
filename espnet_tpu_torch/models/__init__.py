"""Port of espnet_tpu/models."""
