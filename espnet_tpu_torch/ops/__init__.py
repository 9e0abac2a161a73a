"""Port of espnet_tpu/ops."""
