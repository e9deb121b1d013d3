"""Wireless channel substrate."""
