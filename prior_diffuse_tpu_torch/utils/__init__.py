"""Logging: Python logging setup and the JSONL metrics sink."""
