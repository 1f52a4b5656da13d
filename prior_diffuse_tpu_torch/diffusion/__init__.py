"""Diffusion core of the serving path: schedule, sigma mask, reverse chain."""
