"""Diffusion core: schedule, q-sample and sigma mask, reverse chain."""
