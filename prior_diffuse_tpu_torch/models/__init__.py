"""Models of the serving path: the DiffUNet prior and the DDPM denoisers (DiffUNet1, Nocon)."""
