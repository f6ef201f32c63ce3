"""PHY substrate of the port (5G NR PUSCH, paper 5/6)."""
