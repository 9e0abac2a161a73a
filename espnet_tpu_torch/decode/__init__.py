"""Port of espnet_tpu/decode."""
