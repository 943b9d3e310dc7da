"""DSP blocks (one module per reference family)."""
