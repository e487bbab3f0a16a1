"""Runnable checks of the port (counterpart of the repo's ``scripts/``)."""
