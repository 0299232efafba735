"""Vocos vocoder (EnCodec codes → 24 kHz waveform)."""
