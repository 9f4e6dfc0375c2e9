"""Optimizers of the port: AdamW with masked params."""
