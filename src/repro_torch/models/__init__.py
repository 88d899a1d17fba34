"""The dense transformer substrate and the MEM dual-tower embedder."""
