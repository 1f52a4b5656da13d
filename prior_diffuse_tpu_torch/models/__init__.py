"""Models of the serving path: the DiffUNet prior and the DiffUNet1 denoiser."""
