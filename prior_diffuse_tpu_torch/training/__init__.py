"""Training: the DDPM trainer, its scaffold, optimizer, plateau control and checkpoints."""
