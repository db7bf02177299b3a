"""CLIP towers and the zero-shot classifier head."""
