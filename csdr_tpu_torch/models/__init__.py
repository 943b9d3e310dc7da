"""Receiver pipeline definitions."""
