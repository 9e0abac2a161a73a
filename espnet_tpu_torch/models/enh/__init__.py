"""Port of espnet_tpu/models/enh: the ASR frontend's parts."""
