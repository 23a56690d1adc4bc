"""Tacotron-2 spectrogram predictor (inference side)."""
