"""Uplink gradient compression."""
