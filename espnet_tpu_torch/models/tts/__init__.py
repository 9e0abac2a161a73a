"""TTS models without the GAN family: FastSpeech2, Tacotron2,
Transformer-TTS, ProDiff, GST, speaker conditioning and VC (port of
espnet_tpu/models/tts/)."""
