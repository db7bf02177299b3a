"""Configuration helpers."""
