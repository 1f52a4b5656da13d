"""Serving: the ``Enhancer`` (one batch) and whole-file enhancement."""
