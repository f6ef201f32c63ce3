"""Data-only model configs of the side LM stack (the ported families)."""
