"""Language models that are not neural networks (port of espnet_tpu/lm)."""
