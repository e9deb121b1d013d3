"""Federated data pipeline."""
