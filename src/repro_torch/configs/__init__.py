"""Data-only model configs of the side LM stack, one module per arch (all ten)."""
