"""Spectral front and back end: STFT/ISTFT, compression, normalisation."""
