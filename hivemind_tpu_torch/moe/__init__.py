"""Mixture-of-experts serving of the port (server side; the client comes later)."""
