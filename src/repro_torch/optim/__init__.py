"""Optimizer (AdamW with int8 moments) and gradient compression."""
