"""Model configuration, layers and the decoder-only LM."""
