"""WaveNet vocoder (inference side)."""
