"""Model assembly: configuration, layers, block stack and the LM entry points."""
